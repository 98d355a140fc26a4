"""``parallel.mesh.sample_sharding`` against the JAX package's.

Over 2 and 4 gloo ranks (tests/torch_parallel_worker.py) and the meshes
``test_mesh_shapes_and_errors`` builds, each rank's block of a ``[k, B]``
evaluation tensor, ``((n_data, row), (n_sample, col))``, equals the block
that JAX's ``sample_sharding(mesh).devices_indices_map((k, B))`` gives the
device at the same place of its mesh (JAX's 8 virtual CPU devices). The
blocks are integers: no tolerance.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu.config import MeshConfig as JaxMeshConfig
from vae_mdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vae_mdl_tpu.parallel.mesh import sample_sharding as jax_sample_sharding
from vae_mdl_tpu_torch.parallel.mesh import sample_sharding

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, W.spawn("sharding_suite", world, tmp_path_factory.mktemp(f"shard{world}"))


def _jax_blocks(world, data, sample, model):
    """{place in the mesh: (row, col)} of JAX's sample sharding of a [k, B]
    tensor."""
    mesh = jax_make_mesh(JaxMeshConfig(data=data, sample=sample, model=model),
                         jax.devices()[:world])
    n_data, n_sample = mesh.shape["data"], mesh.shape["sample"]
    k, b = 3 * n_sample, 5 * n_data
    indices = jax_sample_sharding(mesh).devices_indices_map((k, b))
    blocks = {}
    for place, device in np.ndenumerate(mesh.devices):
        k_slice, b_slice = indices[device]
        blocks[place] = ((n_data, (b_slice.start or 0) // (b // n_data)),
                         (n_sample, (k_slice.start or 0) // (k // n_sample)))
    return blocks


def test_sample_sharding_equals_jax(ranks):
    world, outs = ranks
    assert len(jax.devices()) >= world
    for key in outs[0]:
        data, sample, model = key
        data = data if data > 0 else world // (sample * model)
        want = _jax_blocks(world, data, sample, model)
        for rank, out in enumerate(outs):
            got, layout, names = out[key]
            arr = np.asarray(layout)
            place = tuple(int(i) for i in np.argwhere(arr == rank)[0])
            assert got == want[place], (key, rank, names)
        # every block of the tensor is some rank's
        assert {out[key][0] for out in outs} == set(want.values())


def test_no_mesh_is_one_block():
    assert sample_sharding(None) == ((1, 0), (1, 0))
