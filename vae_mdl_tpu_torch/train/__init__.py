"""Training: learning-rate schedules, optimizers and the train state, the
train and eval steps, checkpoints and the trainer loop."""
