"""Multi-chip sharding on the 8-virtual-CPU-device mesh."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from silent_speech.data.augment import OFFICIAL_AUGMENT
from silent_speech.models import bigru as model
from silent_speech.parallel import (
    bigru_param_specs,
    make_mesh,
    make_sharded_infer_fn,
    make_sharded_train_step,
    shard_params,
)
from silent_speech.train.step import StepConfig, make_optimizer


def _setup(use_roi=True, num_classes=5):
    mcfg = model.BiGRUConfig(x_dim=24, num_classes=num_classes, use_roi=use_roi,
                             hidden=16, roi_emb=8)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    return mcfg, params


def _batch(rng, B, T=12, D=24, use_roi=True):
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = rng.integers(6, T + 1, B).astype(np.int32)
    roi = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8) if use_roi else None
    y = rng.integers(0, 5, B).astype(np.int32)
    return X, lengths, roi, y


def test_dp_train_step_runs_and_matches_single_device(cpu_mesh_devices, rng):
    """A DP step over 8 devices must produce the same params as 1 device."""
    mcfg, params0 = _setup()
    scfg = StepConfig(model=mcfg, augment=None)  # augment off for determinism
    opt = make_optimizer(1e-3)

    mesh8 = make_mesh(cpu_mesh_devices, data=8, model=1)
    p8, os8, step8 = make_sharded_train_step(scfg, opt, mesh8, params0)
    mesh1 = make_mesh(cpu_mesh_devices[:1], data=1, model=1)
    p1, os1, step1 = make_sharded_train_step(scfg, opt, mesh1, params0)

    X, lengths, roi, y = _batch(rng, 16)
    key = jax.random.PRNGKey(5)
    p8, os8, m8 = step8(p8, os8, key, X, lengths, roi, y)
    p1, os1, m1 = step1(p1, os1, key, X, lengths, roi, y)

    np.testing.assert_allclose(float(m8["loss"]), float(m1["loss"]), atol=1e-5)
    for a, b in zip(jax.tree.leaves(p8), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_tp_infer_matches_replicated(cpu_mesh_devices, rng):
    """Tensor-parallel sharded forward == replicated forward."""
    mcfg, params = _setup()
    mesh = make_mesh(cpu_mesh_devices, data=4, model=2)
    specs = bigru_param_specs(params, tensor_parallel=True)
    p_tp = shard_params(params, mesh, specs)

    X, lengths, roi, _ = _batch(rng, 8)
    fwd = make_sharded_infer_fn(mcfg, mesh)
    got = np.asarray(fwd(p_tp, X, lengths, roi))
    ref = np.asarray(model.live_forward(
        params, mcfg, jnp.asarray(X), jnp.asarray(lengths), jnp.asarray(roi)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_tp_dp_train_step_executes(cpu_mesh_devices, rng):
    """Full 4x2 DP+TP training step compiles, executes, and updates params."""
    mcfg, params = _setup()
    scfg = StepConfig(model=mcfg, augment=OFFICIAL_AUGMENT)
    opt = make_optimizer(1e-3)
    mesh = make_mesh(cpu_mesh_devices, data=4, model=2)
    p, os_, step = make_sharded_train_step(
        scfg, opt, mesh, params, tensor_parallel=True)
    X, lengths, roi, y = _batch(rng, 8)
    # snapshot BEFORE stepping: the sharded step donates params/opt_state
    # (the input buffers are dead after the call on donation-capable
    # backends)
    p_before = [np.asarray(a) for a in jax.tree.leaves(p)]
    p2, os2, m = step(p, os_, jax.random.PRNGKey(1), X, lengths, roi, y)
    assert np.isfinite(float(m["loss"]))
    # params actually changed
    delta = max(
        float(np.abs(a - np.asarray(b)).max())
        for a, b in zip(p_before, jax.tree.leaves(p2))
    )
    assert delta > 0

    # TP params are genuinely sharded over 'model'
    wi = p2["gru"][0]["fwd"]["wi"]
    assert wi.sharding.spec == P(None, "model")


def test_grad_sync_is_global_mean(cpu_mesh_devices, rng):
    """DP semantics: the update must reflect the *global* batch, not one
    shard's. Compare an 8-way step on batch B with a 1-device step on the
    same full batch (already covered) and ensure different per-shard data
    changes the result vs using only shard 0's data."""
    mcfg, params0 = _setup(use_roi=False)
    scfg = StepConfig(model=mcfg, augment=None)
    opt = make_optimizer(1e-2)
    mesh8 = make_mesh(cpu_mesh_devices, data=8, model=1)
    X, lengths, roi, y = _batch(rng, 8, use_roi=False)

    p8, os8, step8 = make_sharded_train_step(scfg, opt, mesh8, params0)
    p8, _, _ = step8(p8, os8, jax.random.PRNGKey(0), X, lengths, None, y)

    X0 = np.tile(X[:1], (8, 1, 1))  # every shard sees sample 0
    l0 = np.tile(lengths[:1], 8)
    y0 = np.tile(y[:1], 8)
    q8, qs8, qstep = make_sharded_train_step(scfg, opt, mesh8, params0)
    q8, _, _ = qstep(q8, qs8, jax.random.PRNGKey(0), X0, l0, None, y0)

    diffs = [
        float(jnp.abs(a - b).max())
        for a, b in zip(jax.tree.leaves(p8), jax.tree.leaves(q8))
    ]
    assert max(diffs) > 1e-6


def test_predictor_shard_matches_unsharded(cpu_mesh_devices, rng):
    """Predictor.shard (the eval-dataset mesh_shape= path) must reproduce the
    unsharded logits exactly, including on a ragged batch that needs
    data-axis padding."""
    from silent_speech.infer.predictor import Predictor

    mcfg, params = _setup()
    i2l = {i: w for i, w in enumerate(["a", "b", "c", "d", "e"])}
    p_ref = Predictor(params=params, cfg=mcfg, id_to_label=i2l, max_t=12)
    p_sh = Predictor(params=params, cfg=mcfg, id_to_label=i2l, max_t=12)
    p_sh.shard(make_mesh(cpu_mesh_devices, data=4, model=2))

    for B in (8, 5):  # 5 is ragged on data=4 -> pad path
        X, lengths, roi, _y = _batch(rng, B)
        a = p_ref.predict_batch(X, lengths, roi)
        b = p_sh.predict_batch(X, lengths, roi)
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_predictor_shard_keeps_serving_knobs(cpu_mesh_devices, rng,
                                             monkeypatch):
    """Predictor.shard must forward the FULL serving-knob surface (precision,
    dtype) to the sharded forward, and the sharded forward must match the
    unsharded one."""
    from silent_speech.infer.predictor import Predictor
    from silent_speech.parallel import train_sharded

    mcfg, params = _setup()
    i2l = {i: w for i, w in enumerate(["a", "b", "c", "d", "e"])}
    p = Predictor(params=params, cfg=mcfg, id_to_label=i2l, max_t=12,
                  matmul_precision="highest", compute_dtype="float32")
    seen = {}
    orig = train_sharded.make_sharded_infer_fn

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(train_sharded, "make_sharded_infer_fn", spy)
    p.shard(make_mesh(cpu_mesh_devices, data=4, model=2))
    assert seen["compute_dtype"] == jnp.float32
    assert seen["matmul_precision"] == "highest"

    p_ref = Predictor(params=params, cfg=mcfg, id_to_label=i2l, max_t=12,
                      matmul_precision="highest")
    X, lengths, roi, _y = _batch(rng, 4)
    np.testing.assert_allclose(p_ref.predict_batch(X, lengths, roi),
                               p.predict_batch(X, lengths, roi), atol=1e-5)


def test_train_loop_with_mesh(tmp_path, cpu_mesh_devices):
    """TrainConfig.mesh_shape drives the full official loop through the
    sharded DP step on the virtual mesh."""
    import jax as _jax
    from silent_speech.core.config import TrainConfig
    from silent_speech.data.synthetic import generate_corpus
    from silent_speech.train import train

    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"], seed=9)
    with _jax.default_device(cpu_mesh_devices[0]):
        r = train(TrainConfig(
            clip_dir=str(corpus), out_path=str(tmp_path / "m.ckpt"),
            epochs=2, patience=5, batch_size=8, max_t=40,
            mesh_shape={"data": 8, "model": 1},
        ), verbose=False)
    assert len(r["history"]) == 2
    assert all(np.isfinite(h["train_loss"]) for h in r["history"])


def test_mesh_from_shape_rejects_oversized_on_accelerator(monkeypatch):
    """An oversized mesh_shape must fail loudly (with the emulation recipe)
    rather than silently building a CPU mesh in an accelerator-default
    process — that fallback is reserved for callers that pinned
    jax.default_device to CPU first."""
    import pytest

    from silent_speech.parallel import mesh as M

    monkeypatch.setattr(M, "_default_device_is_cpu", lambda: False)
    with pytest.raises(ValueError, match="emulate a larger mesh"):
        M.mesh_from_shape({"data": 1024})


def test_mesh_from_shape_uses_device_subset_on_larger_backend():
    """A fully-explicit shape SMALLER than the backend (mesh_shape=data:4 on
    the 8-virtual-CPU emulation, or a future multi-chip host) must build a
    mesh over the first `need` devices — not crash on make_mesh's
    exact-count check."""
    from silent_speech.parallel import mesh as M

    m = M.mesh_from_shape({"data": 4})
    assert m.devices.shape == (4, 1)
    m = M.mesh_from_shape({"data": 2, "model": 2})
    assert m.devices.shape == (2, 2)
    # 'data' omitted still absorbs ALL the backend's devices (the documented
    # default — here the 8-CPU emulation backend, whatever the host has)
    m = M.mesh_from_shape({"model": 2})
    assert m.devices.shape[1] == 2 and m.devices.size >= 4


def test_mesh_from_shape_rejects_unknown_axis():
    """A typoed axis name (mesh_shape=dta:8) must error, not silently build
    a different mesh than the user asked for."""
    import pytest

    from silent_speech.parallel import mesh as M

    with pytest.raises(ValueError, match="unknown mesh axis"):
        M.mesh_from_shape({"dta": 8})
