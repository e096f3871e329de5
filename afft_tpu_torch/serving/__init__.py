"""Static-shape serving: one CUDA graph per batch bucket (``graphs``)."""
