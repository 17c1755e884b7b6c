"""Batch inference from waveform to intent probabilities."""
