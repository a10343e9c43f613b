"""silent_speech — a JAX (XLA) word-level lip-reading framework.

A from-scratch rebuild of the capabilities of davdwan21/Silent-Speech
(reference layout: record_landmarks_official.py / train_model_official.py /
live_infer_official.py + the `inactive/` capability envelope), re-designed for
an accelerator (an NVIDIA GPU):

- all per-frame CPU Python loops of the reference become batched, jitted XLA
  computations over (B, T) windows;
- the BiGRU runs as a `lax.scan` over a fused cell with the big input
  projection hoisted into one matmul over all timesteps;
- training is a single jitted step, shardable over a `jax.sharding.Mesh`
  (data parallel by default, tensor-parallel hooks on the GRU hidden axis);
- the `.npz` clip format and checkpoint metadata of the reference are kept as
  public contracts so datasets and workflows carry over unchanged.

Subpackages
-----------
core      dtypes / schemas: ClipBatch, npz codec, checkpoint schema, torch import
ops       numerical building blocks (GRU scan, attention pool, conv stacks,
          feature extraction, ROI resampling, CTC) incl. Pallas kernels
models    model families: BiGRUClassifier (official), GRUClassifier variants,
          TemporalCNN, MLP summary model, BiGRU-CTC
data      npz corpus scanning, splits, weighted sampling, augmentation, batching
train     jitted/sharded train loops, optimizers, checkpointing
infer     clip predictor, dataset evaluator, streaming engines, CTC decoding
parallel  mesh construction and sharding rules
runtime   host-side runtime: ring buffers, capture shims, native bindings
apps      CLI entry points mirroring the reference scripts
"""

__version__ = "0.1.0"
