"""The benchmark's plain reference (``transforms.py``) and its frozen taps."""
