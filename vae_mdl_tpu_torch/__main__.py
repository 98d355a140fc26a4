"""``python -m vae_mdl_tpu_torch model05 --n-updates N``: the ``train``
subcommand of the CLI (``cli/run.py``), as ``train_model.py`` is the JAX
package's."""
import sys

from vae_mdl_tpu_torch.cli.run import main

if __name__ == "__main__":
    main(["train"] + sys.argv[1:])
