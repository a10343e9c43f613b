"""End-to-end training on a synthetic corpus + checkpoint round-trip."""

import numpy as np

import jax
import jax.numpy as jnp

from silent_speech.core.config import TrainConfig
from silent_speech.data.synthetic import generate_corpus
from silent_speech.models import bigru as model
from silent_speech.train import (
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
    smoothed_cross_entropy,
    train,
)


def test_smoothed_ce_matches_torch():
    import torch

    logits = np.array([[2.0, 0.5, -1.0], [0.1, 0.2, 0.3]], np.float32)
    y = np.array([0, 2])
    ref = torch.nn.CrossEntropyLoss(label_smoothing=0.05)(
        torch.from_numpy(logits), torch.from_numpy(y)
    ).item()
    got = float(smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(y), 3, 0.05))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_one_step_training_parity():
    """One official train step — forward, CE(ls=0.05) backward, global-norm
    clip 1.0, Adam 3e-4 (reference train_model_official.py:426-439) — run
    from identical imported weights in torch-CPU and through
    train/step.make_batch_train_step must produce the same gradients and the
    same post-step parameters (<= 1e-4 corpus-wide).

    Dropout is disabled on both sides (torch .eval(); jax dropout rates 0) so
    the compared gradient is deterministic; everything else — the standardized
    training forward, packed-GRU backward vs masked-scan backward, loss,
    clipping, Adam bias correction — is the exact training path. This pins
    the training-side numeric surface the inference golden tests can't see.
    """
    import torch

    from silent_speech.core.torch_import import import_bigru_classifier
    from silent_speech.train.step import (
        StepConfig,
        make_batch_train_step,
    )
    from tests.test_model_parity import _TorchBiGRUClassifier

    torch.manual_seed(11)
    tm = _TorchBiGRUClassifier(180, 10, True, standardize_roi=True)
    tm.eval()  # dropout off: deterministic gradients
    sd0 = {k: v.clone() for k, v in tm.state_dict().items()}

    rng = np.random.default_rng(5)
    B, T = 16, 24
    X = rng.standard_normal((B, T, 180)).astype(np.float32)
    R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    L = rng.integers(6, T + 1, size=B).astype(np.int64)
    L[0] = T
    y = rng.integers(0, 10, size=B).astype(np.int64)

    # --- torch reference step (train_model_official.py:426-439) ---
    opt_t = torch.optim.Adam(tm.parameters(), lr=3e-4)
    logits_t = tm(torch.from_numpy(X), torch.from_numpy(L),
                  torch.from_numpy(R))
    loss_t = torch.nn.CrossEntropyLoss(label_smoothing=0.05)(
        logits_t, torch.from_numpy(y))
    opt_t.zero_grad()
    loss_t.backward()
    tgrad_sd = {k: p.grad.clone() for k, p in tm.named_parameters()}
    torch.nn.utils.clip_grad_norm_(tm.parameters(), 1.0)
    opt_t.step()

    # --- same step in this framework ---
    mcfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True,
                             gru_dropout=0.0, head_dropout=0.0)
    params = jax.tree.map(jnp.asarray, import_bigru_classifier(sd0))
    Xj = jnp.asarray(X)
    Lj = jnp.asarray(L.astype(np.int32))
    Rj = jnp.asarray(R)
    yj = jnp.asarray(y.astype(np.int32))

    def loss_fn(p):
        lg = model.train_forward(p, mcfg, Xj, Lj, Rj, train=True,
                                 rng=jax.random.PRNGKey(0))
        return smoothed_cross_entropy(lg, yj, 10, 0.05)

    loss_j, jgrads = jax.value_and_grad(loss_fn)(params)
    np.testing.assert_allclose(float(loss_j), float(loss_t.item()), atol=1e-5)

    # raw (pre-clip) gradients, torch layout mapped by the same importer
    tgrads = import_bigru_classifier(tgrad_sd)
    gerr = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.max(jnp.abs(a - jnp.asarray(b)))),
        jgrads, tgrads)))
    assert gerr <= 1e-4, f"gradient drift {gerr:.2e} vs torch"

    # full jitted step: clip + Adam + apply
    opt_j = make_optimizer(3e-4)
    scfg = StepConfig(model=mcfg, label_smoothing=0.05, augment=None)
    step = make_batch_train_step(scfg, opt_j)
    new_params, _, _, metrics = step(params, opt_j.init(params),
                                     jax.random.PRNGKey(0), Xj, Lj, Rj, yj)
    post_t = import_bigru_classifier(tm.state_dict())
    perr = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.max(jnp.abs(a - jnp.asarray(b)))),
        new_params, post_t)))
    assert perr <= 1e-4, f"post-step param drift {perr:.2e} vs torch"
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_t.item()),
                               atol=1e-5)


def test_multi_step_training_parity():
    """FOUR consecutive official train steps on distinct batches must track
    torch parameter-for-parameter (<= 5e-4) — beyond the one-step test this
    pins the OPTIMIZER-STATE evolution: Adam first/second-moment
    accumulation and per-step bias correction across t=1..4, and the
    clip-then-step interaction (train_model_official.py:426-439)."""
    import torch

    from silent_speech.core.torch_import import import_bigru_classifier
    from silent_speech.train.step import (
        StepConfig,
        make_batch_train_step,
    )
    from tests.test_model_parity import _TorchBiGRUClassifier

    torch.manual_seed(3)
    tm = _TorchBiGRUClassifier(180, 10, True, standardize_roi=True)
    tm.eval()
    sd0 = {k: v.clone() for k, v in tm.state_dict().items()}

    rng = np.random.default_rng(9)
    B, T, STEPS = 8, 16, 4
    batches = []
    for _ in range(STEPS):
        X = rng.standard_normal((B, T, 180)).astype(np.float32)
        R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
        L = rng.integers(6, T + 1, size=B).astype(np.int64)
        y = rng.integers(0, 10, size=B).astype(np.int64)
        batches.append((X, L, R, y))

    opt_t = torch.optim.Adam(tm.parameters(), lr=3e-4)
    crit = torch.nn.CrossEntropyLoss(label_smoothing=0.05)
    t_losses = []
    for X, L, R, y in batches:
        logits = tm(torch.from_numpy(X), torch.from_numpy(L),
                    torch.from_numpy(R))
        loss = crit(logits, torch.from_numpy(y))
        opt_t.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(tm.parameters(), 1.0)
        opt_t.step()
        t_losses.append(float(loss.item()))

    mcfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True,
                             gru_dropout=0.0, head_dropout=0.0)
    params = jax.tree.map(jnp.asarray, import_bigru_classifier(sd0))
    opt_j = make_optimizer(3e-4)
    scfg = StepConfig(model=mcfg, label_smoothing=0.05, augment=None)
    step = make_batch_train_step(scfg, opt_j)
    opt_state = opt_j.init(params)
    key = jax.random.PRNGKey(0)
    for i, (X, L, R, y) in enumerate(batches):
        params, opt_state, key, m = step(
            params, opt_state, key, jnp.asarray(X),
            jnp.asarray(L.astype(np.int32)), jnp.asarray(R),
            jnp.asarray(y.astype(np.int32)))
        np.testing.assert_allclose(float(m["loss"]), t_losses[i], atol=3e-4)

    post_t = import_bigru_classifier(tm.state_dict())
    perr = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.max(jnp.abs(a - jnp.asarray(b)))),
        params, post_t)))
    assert perr <= 5e-4, f"4-step param drift {perr:.2e} vs torch"


def test_multi_step_scan_matches_sequential_steps():
    """make_multi_train_step (K steps in one lax.scan dispatch) must follow
    the SAME training trajectory as K sequential make_train_step dispatches
    from the same starting rng — the scan body is the step body verbatim,
    so only XLA fusion/reassociation differences are allowed."""
    from silent_speech.data.augment import AugmentConfig
    from silent_speech.train.step import (
        StepConfig, make_multi_train_step, make_train_step)

    mcfg = model.BiGRUConfig(x_dim=12, num_classes=4, use_roi=True, hidden=8,
                             roi_emb=4, head_hidden=8)
    scfg = StepConfig(model=mcfg, augment=AugmentConfig())
    opt = make_optimizer(1e-3)
    rng = np.random.default_rng(3)
    N, T, S, B = 20, 14, 5, 6
    X_all = jnp.asarray(rng.standard_normal((N, T, 12)).astype(np.float32))
    len_all = jnp.asarray(rng.integers(4, T + 1, N).astype(np.int32))
    roi_all = jnp.asarray(rng.integers(0, 256, (N, T, 48, 96), dtype=np.uint8))
    y_all = jnp.asarray(rng.integers(0, 4, N).astype(np.int32))
    idx_mat = jnp.asarray(rng.integers(0, N, (S, B)).astype(np.int32))

    key = jax.random.PRNGKey(17)
    params0 = model.init_params(jax.random.PRNGKey(0), mcfg)
    p_seq = jax.tree.map(jnp.copy, params0)
    os_seq = opt.init(p_seq)
    step = make_train_step(scfg, opt)
    k_seq = key
    losses = []
    for s in range(S):
        p_seq, os_seq, k_seq, m = step(
            p_seq, os_seq, k_seq, X_all, len_all, roi_all, y_all, idx_mat[s])
        losses.append(float(m["loss"]))

    p_m = jax.tree.map(jnp.copy, params0)
    os_m = opt.init(p_m)
    multi = make_multi_train_step(scfg, opt)
    p_m, os_m, _, ms = multi(
        p_m, os_m, key, X_all, len_all, roi_all, y_all, idx_mat)
    np.testing.assert_allclose(np.asarray(ms["loss"]), np.asarray(losses),
                               atol=1e-5, rtol=1e-5)
    # param tolerance is Adam-amplified reassociation: the global-norm clip
    # sums grad squares in a different order under the scan compilation, and
    # Adam's m/(sqrt(v)+eps) scales that 1e-7-level drift up ~1000x on
    # near-zero-gradient leaves (same bound as the torch 4-step parity test)
    for a, b in zip(jax.tree.leaves(p_seq), jax.tree.leaves(p_m)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=5e-3)


def test_train_steps_per_dispatch_epoch_parity(tmp_path):
    """The full official loop with steps_per_dispatch=0 (whole epoch in one
    dispatch) reproduces the per-step loop's training run: same batches
    (same sampler rng), same trajectory, same history to float tolerance."""
    corpus = tmp_path / "clips_npz"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"],
                    seed=5)
    base = dict(clip_dir=str(corpus), epochs=2, patience=5, batch_size=4,
                max_t=40, lr=1e-3)
    r1 = train(TrainConfig(out_path=str(tmp_path / "a.ckpt"), **base),
               verbose=False)
    r0 = train(TrainConfig(out_path=str(tmp_path / "b.ckpt"),
                           steps_per_dispatch=0, **base), verbose=False)
    for h1, h0 in zip(r1["history"], r0["history"]):
        np.testing.assert_allclose(h0["train_loss"], h1["train_loss"],
                                   atol=2e-4)
        np.testing.assert_allclose(h0["val_loss"], h1["val_loss"], atol=2e-4)
    for a, b in zip(jax.tree.leaves(r1["params"]),
                    jax.tree.leaves(r0["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-3)
    # chunked mode (K=2) takes the same path
    r2 = train(TrainConfig(out_path=str(tmp_path / "c.ckpt"),
                           steps_per_dispatch=2, **base), verbose=False)
    np.testing.assert_allclose(r2["history"][0]["train_loss"],
                               r1["history"][0]["train_loss"], atol=2e-4)


def test_train_overfits_synthetic_corpus(tmp_path):
    corpus = tmp_path / "clips_npz"
    generate_corpus(str(corpus), clips_per_word=6,
                    words=["yes", "no", "hello", "thanks", "please"], seed=7)
    cfg = TrainConfig(
        clip_dir=str(corpus),
        out_path=str(tmp_path / "model.ckpt"),
        epochs=12,
        patience=12,
        batch_size=10,
        max_t=60,
        lr=1e-3,
    )
    result = train(cfg, verbose=False)
    # separable synthetic classes: must beat 5-way chance (0.2) decisively
    assert result["best_acc"] >= 0.4
    assert result["history"][-1]["train_acc"] >= 0.5
    assert (tmp_path / "model.ckpt").exists()

    params, meta, _ = load_checkpoint(cfg.out_path)
    assert meta["x_dim"] == 180 and meta["use_roi"] is True
    assert meta["labels"] == ["hello", "no", "please", "thanks", "yes"]
    assert meta["gru_layers"] == 2

    # restored params give identical logits to the in-memory best params
    mcfg = result["model_config"]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2, 60, 180)).astype(np.float32)
    roi = rng.integers(0, 256, (2, 60, 48, 96), dtype=np.uint8)
    lengths = np.array([60, 31], np.int32)
    a = model.live_forward(result["params"], mcfg, jnp.asarray(X),
                           jnp.asarray(lengths), jnp.asarray(roi))
    b = model.live_forward(params, mcfg, jnp.asarray(X),
                           jnp.asarray(lengths), jnp.asarray(roi))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_train_bf16_compute_learns(tmp_path):
    """The advertised bf16 training mode (compute_dtype='bfloat16') must
    actually learn, not just run: params stay f32 (the optimizer state and
    updates are full precision), only activations compute in bf16."""
    corpus = tmp_path / "clips_npz"
    generate_corpus(str(corpus), clips_per_word=5,
                    words=["yes", "no", "hello"], seed=3)
    cfg = TrainConfig(
        clip_dir=str(corpus),
        out_path=str(tmp_path / "model_bf16.ckpt"),
        epochs=10,
        patience=10,
        batch_size=8,
        max_t=40,
        lr=1e-3,
        compute_dtype="bfloat16",
    )
    result = train(cfg, verbose=False)
    assert result["history"][-1]["train_acc"] >= 0.5  # beats 3-way chance
    # master params remained f32
    leaf = jax.tree.leaves(result["params"])[0]
    assert leaf.dtype == jnp.float32


def test_checkpoint_roundtrip_with_opt_state(tmp_path):
    key = jax.random.PRNGKey(0)
    mcfg = model.BiGRUConfig(x_dim=16, num_classes=3, use_roi=False, hidden=8)
    params = model.init_params(key, mcfg)
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)
    # take one step so opt state is non-trivial
    grads = jax.tree.map(jnp.ones_like, params)
    updates, opt_state = opt.update(grads, opt_state, params)

    leaves = jax.tree.leaves(opt_state)
    path = str(tmp_path / "ck.ckpt")
    save_checkpoint(path, params, {"x_dim": 16}, opt_state_arrays=leaves)
    p2, meta, opt_leaves = load_checkpoint(path)
    assert meta["x_dim"] == 16
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    for a, b in zip(leaves, opt_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_train_host_data_path(tmp_path):
    """host_data=True: corpus stays in host RAM, batches ship per step."""
    corpus = tmp_path / "hc"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"], seed=8)
    cfg = TrainConfig(
        clip_dir=str(corpus), out_path=str(tmp_path / "hm.ckpt"),
        epochs=2, patience=5, batch_size=4, max_t=40, host_data=True,
    )
    r = train(cfg, verbose=False)
    assert len(r["history"]) == 2
    assert (tmp_path / "hm.ckpt").exists()


def test_roi_remat_identical_gradients():
    """roi_remat=True (recompute ROI-CNN activations in the backward) must
    produce exactly the gradients of the stored-activation path — it is a
    pure memory/traffic transform."""
    mcfg = model.BiGRUConfig(x_dim=16, num_classes=3, use_roi=True, hidden=8,
                             roi_emb=4, head_hidden=8)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((4, 10, 16)).astype(np.float32))
    L = jnp.asarray(np.asarray([10, 6, 8, 5], np.int32))
    R = jnp.asarray(rng.integers(0, 256, (4, 10, 48, 96), dtype=np.uint8))
    y = jnp.asarray(np.asarray([0, 1, 2, 1], np.int32))
    key = jax.random.PRNGKey(7)

    def loss(p, remat):
        lg = model.train_forward(p, mcfg, X, L, R, train=True, rng=key,
                                 roi_remat=remat)
        return smoothed_cross_entropy(lg, y, 3, 0.05)

    g0 = jax.grad(lambda p: loss(p, False))(params)
    g1 = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-7)


def test_roi_remat_survives_string_precision():
    """A global string matmul_precision re-enters forward() through the
    default_matmul_precision scope; that recursion must carry roi_remat with
    it (it used to drop the knob silently, storing the ROI activations the
    caller asked to recompute)."""
    mcfg = model.BiGRUConfig(x_dim=16, num_classes=3, use_roi=True, hidden=8,
                             roi_emb=4, head_hidden=8)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    rng = np.random.default_rng(4)
    X = jnp.asarray(rng.standard_normal((2, 8, 16)).astype(np.float32))
    L = jnp.asarray(np.asarray([8, 6], np.int32))
    R = jnp.asarray(rng.integers(0, 256, (2, 8, 48, 96), dtype=np.uint8))

    def loss(p):
        lg = model.forward(p, mcfg, X, L, R, roi_standardize=True, train=True,
                           rng=jax.random.PRNGKey(1),
                           matmul_precision="highest", roi_remat=True)
        return lg.sum()

    jaxpr = str(jax.make_jaxpr(jax.grad(loss))(params))
    assert "remat" in jaxpr, "roi_remat was dropped by the precision recursion"
