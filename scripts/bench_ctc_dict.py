"""CTC dictionary scoring at open-vocabulary scale.

Measures, on the accelerator: time to score one clip against N-word
dictionaries (N = 100 / 1k / 10k / 20k), one-shot vmapped sweep vs
chunk_words chunked sweeps, plus device memory stats where the runtime
exposes them.

Usage: python scripts/bench_ctc_dict.py
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import json
import string
import time

import numpy as np

import jax
import jax.numpy as jnp

from silent_speech.infer.ctc_decode import CTCDecoder, Dictionary
from silent_speech.models import ctc_model


def synth_words(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    words, seen = [], set()
    while len(words) < n:
        w = "".join(rng.choice(letters, rng.integers(3, 11)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def mem_stats():
    try:
        s = jax.local_devices()[0].memory_stats()
        return {k: s[k] for k in ("bytes_in_use", "peak_bytes_in_use")
                if k in s}
    except Exception:
        return {}


def main():
    params = ctc_model.init_params(jax.random.PRNGKey(0), 180, hidden=192,
                                   gru_layers=3, roi_emb=32)
    rng = np.random.default_rng(0)
    T = 80
    X = rng.standard_normal((T, 180)).astype(np.float32)
    X[:, -3] = 1.0  # keep silence trim from cutting frames
    R = rng.integers(0, 256, (T, 48, 96), dtype=np.uint8)

    results = {}
    for n_words in (100, 1000, 10000, 20000):
        words = synth_words(n_words)
        d = Dictionary.from_words(words)
        row = {}
        for cw in (0, 1024, 2048):
            if cw and n_words <= cw:
                continue
            dec = CTCDecoder(params, d, max_t=T, chunk_words=cw)
            t0 = time.perf_counter()
            ranked = dec.score_clip(X, R)  # includes compile
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                ranked = dec.score_clip(X, R)
                times.append(time.perf_counter() - t0)
            key = "oneshot" if cw == 0 else f"chunk{cw}"
            row[key] = {
                "score_ms": round(1e3 * min(times), 2),
                "first_call_s": round(compile_s, 1),
                "mem": mem_stats(),
            }
            print(f"N={n_words:>6d} {key:>10s}: {row[key]['score_ms']:8.2f} ms"
                  f" (first {compile_s:.1f}s) mem={row[key]['mem']}",
                  flush=True)
            assert len(ranked) == n_words
        results[n_words] = row
    print(json.dumps(results))
    with open("docs/ctc_dict_bench.json", "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
