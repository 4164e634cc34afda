"""Training: AdamW, the trainer, checkpoints and the straggler monitor."""
