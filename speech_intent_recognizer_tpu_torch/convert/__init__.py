"""Weight bridges: reference-layout torch state dicts in and out."""
