"""probes/tp_precision.py on the CPU: every layer the tensor-parallel layout
shards is reported at every slice count, and on the CPU's float32 the sliced
gradients sit within 1e-5 of float64 (measured at most 6e-7 on the narrow
model: the CPU's convolutions do not change algorithm with the width)."""
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu_torch.probes import tp_precision
from vae_mdl_tpu_torch.parallel.tensor import _tp_specs
from vae_mdl_tpu_torch.models.vae import build_model


def test_every_sharded_layer_at_every_slice_count_is_near_float64():
    cfg = W.experiment_of(W.narrow_model())
    got = tp_precision.run(cfg, slices=(1, 2), batch=4, min_features=8, device="cpu",
                           say=lambda line: None)
    model = build_model(cfg.model, device="cpu")
    sharded = {n.rpartition(".")[0] for n, s in
               _tp_specs(dict(model.named_parameters()), model, 2, 8).items() if s}
    assert set(got) == sharded and {"decoder.conv_0", "decoder.Dense_0"} <= sharded
    for name, by_slices in got.items():
        assert set(by_slices) == {1, 2}
        for dx, dw in by_slices.values():
            assert 0.0 <= dx < 1e-5 and 0.0 <= dw < 1e-5, name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_the_probe_needs_a_card_unless_given_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        tp_precision.run(batch=2)
