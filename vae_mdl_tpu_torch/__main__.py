"""``python -m vae_mdl_tpu_torch [train] model05 --n-updates N``: the
``train`` subcommand of the CLI (``cli/run.py``), as ``train_model.py`` is
the JAX package's; any other subcommand named first runs as the CLI runs
it. Under torchrun: ``torchrun --nproc-per-node N -m vae_mdl_tpu_torch
train model05 --mesh N`` (or ``export ... --mesh N``)."""
import sys

from vae_mdl_tpu_torch.cli.run import build_parser, main

if __name__ == "__main__":
    args = sys.argv[1:]
    main(args if args[:1] and args[0] in build_parser().subcommands else ["train"] + args)
