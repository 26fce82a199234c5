"""Plain PyTorch references, one file per model family (`<network>.py`)."""
