"""audio_fewshot_tpu_torch — the PyTorch/CUDA port of ``audio_fewshot_tpu``.

It runs on one NVIDIA GPU (Hopper, sm_90a) and keeps the JAX package's
module names, so each module's counterpart is easy to find.  It imports
torch, numpy and scipy, and nothing of JAX or of the JAX package.

Layer map:
  config      — YAML + includes + var_dict + CLI merge
  data        — episodic sampler, spectrogram datasets, device segment bank
  episode     — dense masked episode batches (clip id + mask for ragged clips)
  models      — resnet12Bdc backbone (nn.Module) + DeepBDC head
  ops         — BDC pool: plain PyTorch version and hand-written CUDA kernel
  eval        — episodic test harness with the energy calibration pass
  utils       — aggregation, weight conversion, checkpoint, logging, seeding
"""

__version__ = "0.1.0"
