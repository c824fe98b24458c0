"""Fine-tuning entry points."""
