"""Training: losses, mixup, optimizers and schedules, and the step runner."""
