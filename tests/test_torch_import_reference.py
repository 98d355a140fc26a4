"""Reference-checkpoint interop of the port (utils/import_reference.py)
against the JAX package's, on Keras checkpoints built as
tests/test_import_reference.py builds them.

The Keras mirrors of the reference models and the checkpoint writer below are
copies of that file's helpers: each writes a TF object-graph checkpoint with
the key layout a reference ``save_weights`` run produces. Both packages import
the same file; the port's forward on its import then equals JAX's forward on
its own import (encoder q and decoder output), which pins the Dense and Conv
identity maps and the Conv2DTranspose transform through ``kernel_from_flax``.

Tolerances: rtol/atol 1e-5 (the same float32 weights, convolutions and dense
layers summed in another order); round trips are exact.
"""
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vae_mdl_tpu.models import build_model as jax_build_model  # noqa: E402
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS  # noqa: E402
from vae_mdl_tpu.utils.import_reference import (  # noqa: E402
    load_reference_weights as jax_load_reference_weights,
)
from vae_mdl_tpu_torch.models.vae import build_model  # noqa: E402
from vae_mdl_tpu_torch.models.zoo import MODELS  # noqa: E402
from vae_mdl_tpu_torch.utils.convert import params_to_flax  # noqa: E402
from vae_mdl_tpu_torch.utils.import_reference import (  # noqa: E402
    load_reference_weights,
    save_reference_weights,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

layers = tf.keras.layers


class _BasicBlock(tf.keras.Model):  # models/model01.py:70-86
    def __init__(self, n_hidden, n_latent):
        super().__init__()
        self.l1 = layers.Dense(n_hidden, activation=tf.nn.tanh)
        self.l2 = layers.Dense(n_hidden, activation=tf.nn.tanh)
        self.lmu = layers.Dense(n_latent, activation=None)
        self.lstd = layers.Dense(n_latent, activation=tf.exp)

    def call(self, x):
        h2 = self.l2(self.l1(x))
        return self.lmu(h2), self.lstd(h2)


class _Enc01(tf.keras.Model):  # models/model01.py:90-99
    def __init__(self):
        super().__init__()
        self.encode_x_to_z = _BasicBlock(200, 100)

    def call(self, x):
        return self.encode_x_to_z(tf.reshape(x, [x.shape[0], -1]))


class _Dec01(tf.keras.Model):  # models/model01.py:102-116
    def __init__(self):
        super().__init__()
        self.decode_z_to_x = tf.keras.Sequential([
            layers.Dense(200, activation=tf.nn.tanh),
            layers.Dense(200, activation=tf.nn.tanh),
            layers.Dense(784, activation=None),
        ])

    def call(self, z):
        return self.decode_z_to_x(z)


class _Ref01(tf.keras.Model):
    def __init__(self):
        super().__init__()
        self.encoder = _Enc01()
        self.decoder = _Dec01()

    def call(self, x):
        mu, std = self.encoder(x)
        return self.decoder(mu)


class _Enc05(tf.keras.Model):  # models/model05.py:24-52; act=gelu -> model06
    def __init__(self, n_latent=20, act=tf.nn.relu):
        super().__init__()
        self.convs = tf.keras.Sequential([
            layers.Conv2D(32, 3, strides=1, padding="same", activation=act),
            layers.Conv2D(64, 3, strides=2, padding="same", activation=act),
            layers.Conv2D(128, 3, strides=2, padding="same", activation=act),
            layers.Conv2D(256, 3, strides=2, padding="same", activation=act),
        ])
        self.fc = layers.Dense(2 * n_latent)

    def call(self, x):
        out = self.convs(x)
        out = tf.reshape(out, [out.shape[0], -1])
        mu, logstd = tf.split(self.fc(out), 2, axis=-1)
        return mu, logstd


class _Dec05(tf.keras.Model):  # models/model05.py:55-92; head/act -> model06
    def __init__(self, n_head=50, act=tf.nn.relu):
        super().__init__()
        self.fc = layers.Dense(4 * 4 * 128, activation=act)
        self.deconvs = tf.keras.Sequential([
            layers.Conv2DTranspose(128, 4, strides=2, padding="same",
                                   activation=act),
            layers.Conv2DTranspose(64, 4, strides=2, padding="same",
                                   activation=act),
            layers.Conv2DTranspose(32, 4, strides=2, padding="same",
                                   activation=act),
            layers.Conv2D(n_head, 3, padding="same", activation=None),
        ])

    def call(self, z):
        h = self.fc(z)
        h = tf.reshape(h, [-1, 4, 4, 128])
        return self.deconvs(h)


class _Ref05(tf.keras.Model):
    def __init__(self):
        super().__init__()
        self.encoder = _Enc05()
        self.decoder = _Dec05()

    def call(self, x):
        mu, logstd = self.encoder(x)
        return self.decoder(mu)


class _Node(tf.Module):
    """Bare trackable node; attribute names become checkpoint key parts."""


def _write_ref_ckpt(prefix, entries):
    """entries: {ref_base_path: keras_layer} -> TF-format checkpoint whose
    keys are `<base>/kernel/.ATTRIBUTES/VARIABLE_VALUE` (+ bias), i.e. the
    Keras-2 save_weights object-graph layout."""
    roots = {}
    for base, layer in entries.items():
        parts = base.split("/")
        obj = roots.setdefault(parts[0].replace("-", "_"), _Node())
        for p in parts[1:]:
            nxt = getattr(obj, p, None)
            if nxt is None:
                nxt = _Node()
                setattr(obj, p, nxt)
            obj = nxt
        obj.kernel = tf.Variable(layer.kernel.numpy())
        obj.bias = tf.Variable(layer.bias.numpy())
    tf.train.Checkpoint(**roots).write(prefix)


def _entries01(ref) -> dict:
    """{ref checkpoint base path: keras layer} for the model01 mirror —
    shared by the checkpoint writer here and the gradient-parity tests
    (tests/test_gradient_parity.py), which need per-layer gradients keyed
    the same way."""
    blk = ref.encoder.encode_x_to_z
    seq = ref.decoder.decode_z_to_x.layers
    return {
        "encoder/encode_x_to_z/l1": blk.l1,
        "encoder/encode_x_to_z/l2": blk.l2,
        "encoder/encode_x_to_z/lmu": blk.lmu,
        "encoder/encode_x_to_z/lstd": blk.lstd,
        "decoder/decode_z_to_x/layer_with_weights-0": seq[0],
        "decoder/decode_z_to_x/layer_with_weights-1": seq[1],
        "decoder/decode_z_to_x/layer_with_weights-2": seq[2],
    }


def _entries_conv(enc, dec) -> dict:
    """Entries for the model02/03/05/06 conv skeleton mirrors."""
    entries = {"encoder/fc": enc.fc, "decoder/fc": dec.fc}
    for i, layer in enumerate(enc.convs.layers):
        entries[f"encoder/convs/layer_with_weights-{i}"] = layer
    for i, layer in enumerate(dec.deconvs.layers):
        entries[f"decoder/deconvs/layer_with_weights-{i}"] = layer
    return entries


class _GLU(tf.keras.layers.Layer):  # modules/glu.py:5-33
    def __init__(self, filters=64):
        super().__init__()
        self.conv = tf.keras.Sequential([
            layers.Conv2D(filters, 3, strides=1, padding="same",
                          activation=tf.nn.relu),
            layers.Conv2D(2 * filters, 3, strides=1, padding="same",
                          activation=None),
        ])

    def call(self, x):
        a, b = tf.split(self.conv(x), 2, axis=-1)
        return tf.nn.relu(a * tf.nn.sigmoid(b))


class _Enc04(tf.keras.Model):  # models/model04.py:24-50
    def __init__(self, n_latent=50):
        super().__init__()
        self.convs = tf.keras.Sequential([
            layers.Conv2D(128, 4, strides=2, padding="same",
                          activation=tf.nn.relu),
            layers.Conv2D(256, 4, strides=2, padding="same",
                          activation=tf.nn.relu),
            layers.Conv2D(256, 3, strides=1, padding="same",
                          activation=tf.nn.relu),
            *[_GLU() for _ in range(5)],
        ])
        self.fc = layers.Dense(2 * n_latent)

    def call(self, x):
        out = self.convs(x)
        out = tf.reshape(out, [out.shape[0], -1])
        return tf.split(self.fc(out), 2, axis=-1)


class _Dec04(tf.keras.Model):  # models/model04.py:53-77
    def __init__(self):
        super().__init__()
        self.fc = layers.Dense(8 * 8 * 63, activation=tf.nn.relu)
        self.deconvs = tf.keras.Sequential([
            layers.Conv2D(256, 3, strides=1, padding="same",
                          activation=tf.nn.relu),
            *[_GLU() for _ in range(5)],
            layers.Conv2DTranspose(128, 4, strides=2, padding="same",
                                   activation=tf.nn.relu),
            layers.Conv2DTranspose(6, 4, strides=2, padding="same",
                                   activation=None),
        ])

    def call(self, z):
        h = tf.reshape(self.fc(z), [-1, 8, 8, 63])
        return self.deconvs(h)


class _BasicBlock06(tf.keras.Model):
    """model06's second-layer BasicBlock mirror: gelu + softplus-lstd
    (model06.py:81-98). Module-level so the gradient-parity tests reuse it."""

    def __init__(self, n_hidden, n_latent):
        super().__init__()
        self.l1 = layers.Dense(n_hidden, activation=tf.nn.gelu)
        self.l2 = layers.Dense(n_hidden, activation=tf.nn.gelu)
        self.lmu = layers.Dense(n_latent, activation=None)
        self.lstd = layers.Dense(n_latent, activation=tf.nn.softplus)

    def call(self, z):
        h2 = self.l2(self.l1(z))
        return self.lmu(h2), self.lstd(h2)


def _entries06(enc, dec, mlp_enc, mlp_dec) -> dict:
    """Entries for the full model06 mirror (conv skeleton + the two
    second-stochastic-layer BasicBlocks, model06.py:188-191)."""
    entries = _entries_conv(enc, dec)
    for name, blk in (("mlp_encoder", mlp_enc), ("mlp_decoder", mlp_dec)):
        for attr in ("l1", "l2", "lmu", "lstd"):
            entries[f"{name}/{attr}"] = getattr(blk, attr)
    return entries


def _keras_model(name):
    """The Keras mirror of ``name``, built, and its checkpoint entries."""
    if name == "model01":
        ref = _Ref01()
        ref(tf.constant(np.zeros((1, 28, 28, 1), np.float32)))
        return _entries01(ref)
    if name == "model04":
        enc, dec = _Enc04(), _Dec04()
        enc(tf.constant(np.zeros((1, 32, 32, 3), np.float32)))
        dec(tf.constant(np.zeros((1, 50), np.float32)))
        entries = {"encoder/fc": enc.fc, "decoder/fc": dec.fc}
        for tower, seq in (("encoder/convs", enc.convs), ("decoder/deconvs", dec.deconvs)):
            for i, layer in enumerate(seq.layers):
                base = f"{tower}/layer_with_weights-{i}"
                if isinstance(layer, _GLU):
                    for j, sub in enumerate(layer.conv.layers):
                        entries[f"{base}/conv/layer_with_weights-{j}"] = sub
                else:
                    entries[base] = layer
        return entries
    act = tf.nn.gelu if name == "model06" else tf.nn.relu
    enc = _Enc05(n_latent=20, act=act)
    dec = _Dec05(n_head=6 if name == "model06" else 50, act=act)
    enc(tf.constant(np.zeros((1, 32, 32, 3), np.float32)))
    dec(tf.constant(np.zeros((1, 20), np.float32)))
    if name != "model06":
        return _entries_conv(enc, dec)
    mlp_enc, mlp_dec = _BasicBlock06(100, 20), _BasicBlock06(100, 20)
    mlp_enc(tf.constant(np.zeros((1, 20), np.float32)))
    mlp_dec(tf.constant(np.zeros((1, 20), np.float32)))
    return _entries06(enc, dec, mlp_enc, mlp_dec)


def _template(name, seed=0):
    model = build_model(MODELS[name], torch.Generator().manual_seed(seed), device="cpu")
    return model, dict(model.named_parameters())


def _jax_template(name):
    """JAX's params template: shapes from ``jax.eval_shape`` (no compile)."""
    jm = jax_build_model(JAX_MODELS[name])
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + tuple(MODELS[name].image_shape)), 1))
    return jm, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _outputs(dist):
    """The parameters of an encoder's or decoder's distribution."""
    for fields in (("loc", "scale"), ("loc", "logscale"), ("parameters",), ("logits",)):
        if all(hasattr(dist, f) for f in fields):
            return [np.asarray(getattr(dist, f)) for f in fields]
    raise TypeError(type(dist))


@pytest.mark.parametrize("name", ["model01", "model05", "model04", "model06"])
def test_forward_matches_jax_on_the_same_import(tmp_path, name):
    rng = np.random.default_rng(0)
    prefix = str(tmp_path / "best")
    _write_ref_ckpt(prefix, _keras_model(name))
    model, params = _template(name)
    model.load_state_dict(load_reference_weights(prefix, name, params))
    jm, jparams = _jax_template(name)
    jparams = jax_load_reference_weights(prefix, name, jparams)

    cfg = MODELS[name]
    x = rng.random((2,) + tuple(cfg.image_shape), dtype=np.float32)
    z = rng.standard_normal((2, cfg.latents()[0])).astype(np.float32)
    pairs = [(model.encoder(torch.from_numpy(x)),
              jm.apply(jparams, jnp.asarray(x), method=lambda m, a: m.encoder(a))),
             (model.decoder(torch.from_numpy(z)),
              jm.apply(jparams, jnp.asarray(z), method=lambda m, a: m.decoder(a)))]
    if name == "model06":  # the second stochastic layer's blocks
        for i, block in enumerate((model.mlp_encoder_1, model.mlp_decoder_1)):
            pairs.append((block(torch.from_numpy(z)), jm.apply(
                jparams, jnp.asarray(z), method=lambda m, a, i=i: (
                    m.mlp_encoders if i == 0 else m.mlp_decoders)[0](a))))
    with torch.no_grad():
        for got, want in pairs:
            for g, w in zip(_outputs(got), _outputs(want)):
                np.testing.assert_allclose(np.asarray(g), w, **TOL)


@pytest.mark.parametrize("name", ["model05", "model06", "model04", "model01"])
def test_save_then_load_roundtrips(tmp_path, name):
    """save -> load into a differently-initialised template is the identity,
    and the JAX package reads the port's file as the same weights."""
    _, params = _template(name)
    prefix = str(tmp_path / "roundtrip")
    save_reference_weights(prefix, name, params)
    _, other = _template(name, seed=7)
    got = load_reference_weights(prefix, name, other)
    assert list(got) == list(params)
    for key, value in params.items():
        assert torch.equal(got[key], value.detach()), key
    _, jparams = _jax_template(name)
    jax_got = jax_load_reference_weights(prefix, name, jparams)
    want = params_to_flax(params, MODELS[name])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jax_got, want)


def test_load_requires_flat_params():
    with pytest.raises(ValueError, match="flat params"):
        load_reference_weights("/nonexistent", "model01", {"params": {"encoder": {}}})


def test_load_rejects_mapping_gaps(tmp_path):
    prefix = str(tmp_path / "best")
    _write_ref_ckpt(prefix, _keras_model("model01"))
    _, params = _template("model01")
    params = {**params, "decoder.extra_layer.weight": torch.zeros(4, 4)}
    with pytest.raises(KeyError, match="unmapped.*extra_layer"):
        load_reference_weights(prefix, "model01", params)


def test_unsupported_families_raise(tmp_path):
    _, params = _template("model01")
    with pytest.raises(NotImplementedError, match="ladder"):
        load_reference_weights(str(tmp_path / "x"), "ladder_svhn", params)


def _common(tmp_path):
    return ["--device", "cpu", "--dataset", "synthetic:mnist", "--batch-size", "8",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "tb"),
            "--mesh", "none"]


def test_cli_eval_from_reference(tmp_path, monkeypatch, capsys):
    """A reference checkpoint evaluated directly: ``eval --from-reference``."""
    from vae_mdl_tpu_torch.cli.run import main

    prefix = str(tmp_path / "ref" / "best")
    _write_ref_ckpt(prefix, _keras_model("model01"))
    monkeypatch.chdir(tmp_path)
    main(["eval", "model01", "--from-reference", prefix, "--n-samples", "4"]
         + _common(tmp_path))
    out = capsys.readouterr().out
    assert "imported reference weights" in out
    assert "test LLH" in out and "WARNING" not in out


def test_cli_convert_then_eval_without_tf(tmp_path, monkeypatch, capsys):
    """``convert`` writes the port's checkpoint from the reference file; the
    eval after it restores that checkpoint with TensorFlow unimportable."""
    from vae_mdl_tpu_torch.cli.run import main

    prefix = str(tmp_path / "ref" / "best")
    _write_ref_ckpt(prefix, _keras_model("model01"))
    monkeypatch.chdir(tmp_path)
    main(["convert", "model01", "--from-reference", prefix, "--tag", "best"]
         + _common(tmp_path))
    out = capsys.readouterr().out
    assert "imported reference weights" in out and "saved 'best' checkpoint" in out
    with pytest.raises(SystemExit, match="refuses to overwrite"):
        main(["convert", "model01", "--from-reference", prefix] + _common(tmp_path))

    monkeypatch.setitem(sys.modules, "tensorflow", None)  # any TF import now fails
    main(["eval", "model01", "--n-samples", "4"] + _common(tmp_path))
    out = capsys.readouterr().out
    assert "loaded 'best'" in out and "test LLH" in out
