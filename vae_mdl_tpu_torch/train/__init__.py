"""Training: learning-rate schedules, optimizers and the train state, and the
train and eval steps. The trainer loop and checkpoints are not ported yet."""
