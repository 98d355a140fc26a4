"""Host milliseconds a train step of the traced slice that the training
loop kept for itself: the program's ``vae/trainer.iter`` span (one
iteration of ``Trainer._fit_loop``) less the parts of it under its
children, the data wait, the step calls and the checkpoint saves."""
from benchmark.lib import spans

CHILDREN = ("data.wait", "step.train", "step.eval", "checkpoint.save")


def read(sl, cell, suffix=None):
    total = spans.self_s(sl, "trainer.iter", CHILDREN)
    return 1e3 * total / sl.steps if total is not None and sl.steps else None
