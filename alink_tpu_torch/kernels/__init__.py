"""alink_tpu_torch.kernels — the hand-written CUDA kernels of the port
(counterpart: ``alink_tpu/kernels``, whose kernels are Pallas for the TPU).

* ``serve`` — the fused dense and sparse serving score kernels
  (``csrc/serve_score.cu``), their plain PyTorch versions and launch
  counts;
* ``ftrl`` — the FTRL state gather, in-order scatter-add and chunk
  walk of the strict steps (``csrc/ftrl_state.cu``), their plain
  versions and launch counts;
* ``tree_hist`` — the level histogram of tree growing
  (``csrc/tree_hist.cu``), its plain version and launch count;
* ``linear`` — the ordered sparse gradient of linear training and the
  ordered scatter-add of FTRL's batch step (``csrc/linear_grad.cu``,
  kernels of the port's own: no TPU kernel computes them), the run plan
  both walk (built on the card by ``csrc/run_plan.cu``), their plain
  versions and launch counts, and the training margins through
  ``serve``'s sparse kernel;
* ``rows`` — the ordered row scatter-add "P3" (``csrc/row_scatter.cu``,
  a kernel of the port's own: Word2Vec's embedding updates, FM's sparse
  gradient, LDA's ``segment_sum``), its plain version and launch count;
* ``fm`` — the FM serving score "P4" (``csrc/fm_score.cu``, the port's
  own: the strict-order score of ``FmModelMapper.serving_kernel``), its
  plain version and launch count;
* ``_build`` — builds ``csrc/*.cu`` with ``nvcc`` at first use and
  loads the library with ``ctypes``.

A wrapper runs its plain version for a tensor on the CPU and launches
its kernel, or raises, for a tensor on the card: there is no fallback
and no switch between the two.
"""
