"""Edge-case robustness: corrupt inputs, short clips, legacy eval paths."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

from silent_speech.core.schema import load_clip
from silent_speech.data.native_loader import load_corpus_arrays
from silent_speech.data.synthetic import generate_corpus
from silent_speech.infer import Predictor, evaluate_temporal_cnn
from silent_speech.models import bigru as model
from silent_speech.runtime import native
from silent_speech.train.checkpoint import reference_meta, save_checkpoint


def test_load_clip_rejects_garbage(tmp_path):
    bad = tmp_path / "me_yes_1_0000.npz"
    bad.write_bytes(b"this is not a zip file")
    with pytest.raises(Exception):
        load_clip(str(bad))


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_reports_corrupt_files(tmp_path):
    generate_corpus(str(tmp_path), clips_per_word=2, words=["yes"], seed=1)
    bad = tmp_path / "me_no_1_0099.npz"
    bad.write_bytes(b"\x00" * 64)
    import glob

    files = sorted(glob.glob(str(tmp_path / "*.npz")))
    with pytest.raises(IOError, match="native loader failed"):
        load_corpus_arrays(files, 40, 180, False)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_f16_falls_back_to_numpy(tmp_path, rng):
    """An X dtype outside the native set (float16) must load CORRECTLY via
    the per-file numpy fallback (code -7) — never as silently-zero features
    with a valid length (the bug class this pins)."""
    X = rng.standard_normal((8, 180)).astype(np.float16)
    path = str(tmp_path / "synth_yes_1700000000_0000.npz")
    np.savez_compressed(path, X=X, label="yes")
    Xa, roi, lengths, has_roi = load_corpus_arrays([path], 40, 180, False)
    assert lengths[0] == 8
    np.testing.assert_allclose(Xa[0, :8], X.astype(np.float32), atol=1e-6)
    assert np.abs(Xa[0, :8]).max() > 0  # really loaded, not zero-filled


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_bigendian_and_fortran_fall_back(tmp_path, rng):
    """Big-endian and fortran-order X are valid npy that numpy reads fine —
    the native path must route them to the per-file fallback (-7), not
    report a misleading 'corrupt X' (-3)."""
    Xbe = rng.standard_normal((6, 180)).astype(">f4")
    pbe = str(tmp_path / "synth_yes_1700000000_0002.npz")
    np.savez_compressed(pbe, X=Xbe, label="yes")
    Xf = np.asfortranarray(rng.standard_normal((6, 180)).astype(np.float32))
    pf = str(tmp_path / "synth_yes_1700000000_0003.npz")
    np.savez_compressed(pf, X=Xf, label="yes")
    Xa, _, lengths, _ = load_corpus_arrays([pbe, pf], 40, 180, False)
    assert list(lengths) == [6, 6]
    np.testing.assert_allclose(Xa[0, :6], Xbe.astype("<f4"), atol=1e-6)
    np.testing.assert_allclose(Xa[1, :6], np.ascontiguousarray(Xf), atol=1e-6)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_scan_corpus_handles_exotic_npy_version(tmp_path, rng):
    """An npy member with a format version other than (1,0)/(2,0) must still
    scan (full-read fallback) — numpy itself reads such files fine."""
    import io
    import zipfile

    from silent_speech.data.corpus import scan_corpus

    X = rng.standard_normal((6, 180)).astype(np.float32)
    buf = io.BytesIO()
    np.lib.format.write_array(buf, X, version=(3, 0))
    path = str(tmp_path / "synth_yes_1700000000_0004.npz")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("X.npy", buf.getvalue())
    with np.load(path) as z:  # sanity: numpy reads it
        assert z["X"].shape == (6, 180)
    idx = scan_corpus(str(tmp_path), verbose=False)
    assert idx.dims == [180]


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_corrupt_roi_is_error(tmp_path, rng):
    """A PRESENT-but-undecodable roi.npy member is a named per-file error —
    never silently treated as 'no roi' (which would train the clip on
    all-zero ROI frames while the numpy path raises on the same file)."""
    import io
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    buf = io.BytesIO()
    np.lib.format.write_array(
        buf, rng.standard_normal((8, 180)).astype(np.float32))
    path = str(tmp_path / "synth_yes_1700000000_0001.npz")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("X.npy", buf.getvalue())
        zf.writestr("roi.npy", b"this is not an npy payload")
    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 40, 180, True)
    assert ei.value.failures[0][1] == -5


def test_predictor_rejects_short_clip(tmp_path, rng):
    cfg = model.BiGRUConfig(x_dim=180, num_classes=3, use_roi=False,
                            hidden=8, gru_layers=1)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    labels = ["a", "b", "c"]
    meta = reference_meta(
        x_dim=180, max_t=90, use_roi=False, roi_w=96, roi_h=48,
        labels=labels, label_to_id={l: i for i, l in enumerate(labels)},
        id_to_label={i: l for i, l in enumerate(labels)}, seed=0,
        gru_layers=1)
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, jax.tree.map(np.asarray, params), meta)
    pred = Predictor.from_checkpoint(path)
    # the reference rejects clips with < 5 frames (live_infer_official.py:341)
    with pytest.raises(ValueError, match="too short"):
        pred.predict_arrays(rng.standard_normal((3, 180)).astype(np.float32),
                            None)


def test_evaluate_temporal_cnn_legacy_path(tmp_path, rng):
    """The dataset_eval.py-semantics sweep: filename labels, fix_dim, z-score."""

    class TorchTemporalCNN(nn.Module):
        def __init__(self, d_in, num_classes):
            super().__init__()
            self.net = nn.Sequential(
                nn.Conv1d(d_in, 128, 5, padding=2), nn.ReLU(),
                nn.Conv1d(128, 128, 5, padding=2), nn.ReLU(),
                nn.AdaptiveAvgPool1d(1))
            self.head = nn.Linear(128, num_classes)

        def forward(self, x):
            return self.head(self.net(x.transpose(1, 2)).squeeze(-1))

    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=2, words=["yes", "no"],
                    seed=2, with_roi=False)
    torch.manual_seed(0)
    tm = TorchTemporalCNN(100, 2).eval()  # d_in 100 != corpus 180: fix_dim path
    from silent_speech.core.torch_import import import_temporal_cnn

    params = import_temporal_cnn(tm.state_dict())
    out = evaluate_temporal_cnn(params, 100, {0: "yes", 1: "no"},
                                str(corpus), verbose=False)
    assert out["n"] == 4 and 0.0 <= out["accuracy"] <= 1.0
    assert 0.0 <= out["avg_conf"] <= 1.0


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_names_every_failure(tmp_path):
    """Per-file error codes surface as named reasons, not just a count."""
    import numpy as np

    from silent_speech.data.native_loader import NativeLoaderError
    from silent_speech.data.synthetic import generate_corpus

    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=1, words=["yes"], seed=1)
    good = sorted(str(p) for p in corpus.glob("*.npz"))
    bad_zip = str(tmp_path / "bad_zip.npz")
    with open(bad_zip, "wb") as f:
        f.write(b"not a zip at all" * 4)
    no_x = str(tmp_path / "no_x.npz")
    np.savez_compressed(no_x, Y=np.zeros((3, 4), np.float32))

    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays(good + [bad_zip, no_x], 40, 180, False)
    failures = {p: (c, r) for p, c, r in ei.value.failures}
    assert failures[bad_zip][0] == -2
    assert "corrupt zip" in failures[bad_zip][1]
    assert failures[no_x][0] == -3
    assert "X.npy" in failures[no_x][1]
    assert good[0] not in failures
    assert bad_zip in str(ei.value) and "corrupt zip" in str(ei.value)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_zip64_falls_back_to_numpy(tmp_path):
    """zip64 archives are rejected by the native parser (code -6), never
    misread — and then loaded correctly through the per-file numpy
    fallback."""
    import io
    import zipfile

    import numpy as np

    X = np.random.default_rng(0).standard_normal((8, 180)).astype(np.float32)
    buf = io.BytesIO()
    np.lib.format.write_array(buf, X)
    path = str(tmp_path / "synth_big_1700000000_0001.npz")
    # force genuine zip64 structures (0xFFFFFFFF central-directory sentinels
    # + zip64 EOCD) on a small file, as numpy would emit for a >4 GB archive
    orig_limit = zipfile.ZIP64_LIMIT
    try:
        zipfile.ZIP64_LIMIT = 0
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            with zf.open(zipfile.ZipInfo("X.npy"), "w", force_zip64=True) as f:
                f.write(buf.getvalue())
    finally:
        zipfile.ZIP64_LIMIT = orig_limit

    # sanity: numpy itself can read it
    with np.load(path) as z:
        np.testing.assert_array_equal(z["X"], X)

    Xa, roi, lengths, has_roi = load_corpus_arrays([path], 40, 180, False)
    assert lengths[0] == 8 and roi is None
    np.testing.assert_allclose(Xa[0, :8], X, atol=1e-6)
    assert not Xa[0, 8:].any()


def test_corrupt_npz_fuzz_sweep(tmp_path, rng):
    """Deterministic fuzz: random truncations/bitflips of a valid clip must
    produce named errors (native loader) or clean exceptions (schema loader),
    never crashes or silent garbage."""
    from silent_speech.core.schema import Clip, load_clip, save_clip
    from silent_speech.data.native_loader import (
        NativeLoaderError,
        load_corpus_arrays,
    )

    good = str(tmp_path / "synth_yes_1700000000_0000.npz")
    clip = Clip(
        X=rng.standard_normal((12, 180)).astype(np.float32),
        ts=np.arange(12, dtype=np.int32), label="yes", speaker="synth",
        idxs=np.arange(88, dtype=np.int32),
        roi=rng.integers(0, 256, (12, 48, 96), np.uint8),
    )
    save_clip(clip, good)
    blob = open(good, "rb").read()

    for i in range(20):
        r = np.random.default_rng(1000 + i)
        data = bytearray(blob)
        if i % 2 == 0:  # truncate
            data = data[: r.integers(1, len(data))]
        else:  # flip a few bytes
            for _ in range(4):
                data[int(r.integers(0, len(data)))] ^= int(r.integers(1, 256))
        bad = str(tmp_path / f"synth_yes_1700000000_{i + 1:04d}.npz")
        open(bad, "wb").write(bytes(data))
        # schema loader: clean exception or a successfully parsed clip
        try:
            load_clip(bad)
        except Exception as e:  # noqa: BLE001
            assert not isinstance(e, (SystemExit, MemoryError))
        # native loader: named failure or successful load, never a crash
        try:
            X, roi, lengths, has_roi = load_corpus_arrays([bad], 20, 180, True)
            assert np.isfinite(X).all()
        except NativeLoaderError as e:
            assert e.failures and e.failures[0][0] == bad
        except Exception as e:  # noqa: BLE001
            assert not isinstance(e, (SystemExit, MemoryError))


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_rejects_lying_npy_shape(tmp_path):
    """An npy header declaring far more data than the payload holds must be
    a named per-file failure, never an out-of-bounds read."""
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    hdr_dict = "{'descr': '<f4', 'fortran_order': False, 'shape': (4096, 180), }"
    pad = 64 - ((10 + len(hdr_dict)) % 64)
    hdr = hdr_dict + " " * (pad - 1) + "\n"
    blob = (b"\x93NUMPY\x01\x00" + len(hdr).to_bytes(2, "little")
            + hdr.encode() + b"\x00" * 16)  # 16 bytes << 4096*180*4
    path = str(tmp_path / "synth_yes_1700000000_0001.npz")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("X.npy", blob)

    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 40, 180, False)
    (p, code, reason), = ei.value.failures
    assert p == path and code == -3


def test_pickled_object_npz_is_refused(tmp_path):
    """A pickled object array in a clip must be refused at load (pickle
    execution is how a malicious corpus would run code); every loader uses
    allow_pickle=False."""
    bad = str(tmp_path / "synth_yes_1700000000_0001.npz")
    np.savez(bad, X=np.zeros((6, 180), np.float32),
             label=np.asarray({"evil": "payload"}, dtype=object))
    with pytest.raises(ValueError, match="pickle"):
        load_clip(bad)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_rejects_overflowing_npy_shape(tmp_path):
    """A shape whose product overflows uint64 must fail the payload guard,
    not wrap around it."""
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    hdr_dict = ("{'descr': '<f4', 'fortran_order': False, "
                "'shape': (4294967295, 4294967295), }")
    pad = 64 - ((10 + len(hdr_dict)) % 64)
    hdr = hdr_dict + " " * (pad - 1) + "\n"
    blob = (b"\x93NUMPY\x01\x00" + len(hdr).to_bytes(2, "little")
            + hdr.encode() + b"\x00" * 64)
    path = str(tmp_path / "synth_yes_1700000000_0002.npz")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("X.npy", blob)
    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 40, 180, False)
    assert ei.value.failures[0][1] == -3


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_zip64_fallback_needs_no_label(tmp_path):
    """The zip64 numpy fallback reads arrays only — an unparseable filename
    (no label) must not fail a loadable archive (the native path never reads
    labels either)."""
    import io
    import zipfile

    X = np.random.default_rng(0).standard_normal((6, 180)).astype(np.float32)
    buf = io.BytesIO()
    np.lib.format.write_array(buf, X)
    path = str(tmp_path / "big.npz")  # no underscore: label unparseable
    orig_limit = zipfile.ZIP64_LIMIT
    try:
        zipfile.ZIP64_LIMIT = 0
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            with zf.open(zipfile.ZipInfo("X.npy"), "w", force_zip64=True) as f:
                f.write(buf.getvalue())
    finally:
        zipfile.ZIP64_LIMIT = orig_limit
    Xa, roi, lengths, _ = load_corpus_arrays([path], 40, 180, False)
    assert lengths[0] == 6
    np.testing.assert_allclose(Xa[0, :6], X, atol=1e-6)


def _zip_member_data_offset(path, name):
    """Absolute offset of a member's raw data (local header + name/extra)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(name)
        hdr_off = info.header_offset
    blob = open(path, "rb").read()
    name_len = int.from_bytes(blob[hdr_off + 26: hdr_off + 28], "little")
    extra_len = int.from_bytes(blob[hdr_off + 28: hdr_off + 30], "little")
    return hdr_off + 30 + name_len + extra_len


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_truncated_central_directory(tmp_path, rng):
    """A central directory cut short of the EOCD's entry count must be a
    corrupt-container error (-2), never an out-of-bounds read."""
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    path = str(tmp_path / "synth_yes_1700000000_0001.npz")
    np.savez(path, X=rng.standard_normal((6, 180)).astype(np.float32))
    blob = bytearray(open(path, "rb").read())
    eocd = blob.rindex(b"PK\x05\x06")
    # lie: EOCD claims 9 entries but the directory holds one
    blob[eocd + 8: eocd + 10] = (9).to_bytes(2, "little")
    blob[eocd + 10: eocd + 12] = (9).to_bytes(2, "little")
    open(path, "wb").write(bytes(blob))
    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 20, 180, False)
    assert ei.value.failures[0][1] == -2
    # (Python's zipfile is LENIENT here — it walks the directory and stops
    # at the first non-CD signature, ignoring the lying count. The native
    # loader is deliberately stricter: a spec-violating container from an
    # untrusted corpus fails loudly instead of being partially trusted.)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_crc_mismatch_is_error(tmp_path, rng):
    """A bit-flipped STORED payload parses structurally but fails CRC-32 —
    the native loader must reject it like Python's zipfile does, never load
    silent garbage (round-4 divergence fix)."""
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    X = rng.standard_normal((6, 180)).astype(np.float32)
    import io

    buf = io.BytesIO()
    np.lib.format.write_array(buf, X)
    path = str(tmp_path / "synth_yes_1700000000_0002.npz")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("X.npy", buf.getvalue())
    off = _zip_member_data_offset(path, "X.npy")
    blob = bytearray(open(path, "rb").read())
    blob[off + 400] ^= 0x40  # deep in the float payload, headers untouched
    open(path, "wb").write(bytes(blob))
    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 20, 180, False)
    assert ei.value.failures[0][1] == -3
    with pytest.raises(zipfile.BadZipFile):  # Python names the same corruption
        with zipfile.ZipFile(path) as zf:
            zf.read("X.npy")


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_exotic_method_falls_back_named(tmp_path, rng):
    """A member with an exotic compression method (bzip2=12) is DECLINED
    (-7) and routed to the numpy fallback; when numpy can't read it either,
    the failure is named per-file, never a crash or silent zeros."""
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    path = str(tmp_path / "synth_yes_1700000000_0003.npz")
    np.savez(path, X=rng.standard_normal((6, 180)).astype(np.float32))
    with zipfile.ZipFile(path) as zf:
        hdr_off = zf.getinfo("X.npy").header_offset
    blob = bytearray(open(path, "rb").read())
    blob[hdr_off + 8: hdr_off + 10] = (12).to_bytes(2, "little")  # local hdr
    cd = blob.rindex(b"PK\x01\x02")
    blob[cd + 10: cd + 12] = (12).to_bytes(2, "little")  # central dir
    open(path, "wb").write(bytes(blob))
    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 20, 180, False)
    p, code, reason = ei.value.failures[0]
    assert code == -7 and "numpy fallback failed" in reason


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_garbage_deflate_stream(tmp_path, rng):
    """A structurally valid DEFLATE member whose compressed bytes are
    garbage must fail inflate as a named -3, not crash zlib."""
    import zipfile

    from silent_speech.data.native_loader import NativeLoaderError

    path = str(tmp_path / "synth_yes_1700000000_0004.npz")
    np.savez_compressed(path, X=rng.standard_normal((64, 180))
                        .astype(np.float32))
    off = _zip_member_data_offset(path, "X.npy")
    blob = bytearray(open(path, "rb").read())
    for i in range(16):  # shred the deflate stream body
        blob[off + 32 + i] ^= 0xA5
    open(path, "wb").write(bytes(blob))
    with pytest.raises(NativeLoaderError) as ei:
        load_corpus_arrays([path], 80, 180, False)
    assert ei.value.failures[0][1] == -3
