"""Classification metrics used by inference reports."""
