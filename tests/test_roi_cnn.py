"""The TinyROICNN embedding against a per-frame reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from silent_speech.models.bigru import (
    init_roi_cnn,
    preprocess_roi,
    roi_cnn_forward,
    roi_embedding,
)


def _per_frame_reference(params, roi_u8, standardize):
    """Each frame through the plain CNN on its own, at float32 'highest'."""
    out = []
    with jax.default_matmul_precision("highest"):
        for f in roi_u8:
            r = preprocess_roi(jnp.asarray(f)[None, None], standardize)
            out.append(np.asarray(roi_cnn_forward(params, r))[0, 0])
    return np.stack(out)


@pytest.mark.parametrize("n", [5, 33, 64])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 5e-2)])
@pytest.mark.parametrize("standardize", [False, True])
def test_roi_embedding_matches_per_frame(rng, n, dtype, tol, standardize):
    """Frames folded into one conv batch agree with each frame on its own,
    for odd and even frame counts. bf16 compute holds a bf16-rounding
    tolerance."""
    params = init_roi_cnn(jax.random.PRNGKey(n))
    roi = rng.integers(0, 256, (n, 48, 96), dtype=np.uint8)
    ref = _per_frame_reference(params, roi, standardize)
    got = np.asarray(roi_embedding(
        params, jnp.asarray(roi)[:, None], standardize=standardize,
        compute_dtype=dtype), np.float32)[:, 0]
    assert got.shape == (n, 32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("standardize", [False, True])
def test_float_frames_match_uint8(rng, standardize):
    """Float frames already /255 (the CTC collate contract) embed exactly
    as the uint8 frames they came from."""
    params = init_roi_cnn(jax.random.PRNGKey(7))
    roi = rng.integers(0, 256, (2, 6, 48, 96), dtype=np.uint8)
    a = roi_embedding(params, jnp.asarray(roi), standardize=standardize)
    b = roi_embedding(params, jnp.asarray(roi.astype(np.float32) / 255.0),
                      standardize=standardize)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_remat_gradient_is_identical(rng):
    """roi_remat recomputes the activations in the backward; the gradient
    is the same to float32 round-off."""
    params = init_roi_cnn(jax.random.PRNGKey(8))
    roi = jnp.asarray(rng.integers(0, 256, (2, 4, 48, 96), dtype=np.uint8))

    def loss(p, remat):
        return jnp.sum(roi_embedding(p, roi, standardize=True, train=True,
                                     roi_remat=remat) ** 2)

    g0 = jax.grad(loss)(params, False)
    g1 = jax.grad(loss)(params, True)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                         atol=1e-6), g0, g1)
