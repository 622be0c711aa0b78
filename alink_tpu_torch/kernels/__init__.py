"""alink_tpu_torch.kernels — the hand-written CUDA kernels of the port
(counterpart: ``alink_tpu/kernels``, whose kernels are Pallas for the TPU).

* ``serve`` — the fused dense and sparse serving score kernels
  (``csrc/serve_score.cu``), their plain PyTorch versions and launch
  counts;
* ``ftrl`` — the FTRL state gather, in-order scatter-add and chained
  correction kernels (``csrc/ftrl_state.cu``), their plain versions and
  launch counts;
* ``_build`` — builds ``csrc/*.cu`` with ``nvcc`` at first use and
  loads the library with ``ctypes``.

A wrapper runs its plain version for a tensor on the CPU and launches
its kernel, or raises, for a tensor on the card: there is no fallback
and no switch between the two.
"""
