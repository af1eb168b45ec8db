"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper runs its plain version for CPU tensors and launches its kernel
(``csrc/<name>.cu``, built at first use by :mod:`.cuda_build`) for CUDA
tensors, or raises; it never falls back.  Module-level ``*launches``
integers count the kernel launches.

* :mod:`.gru_scan` — ``bigru_scan``, the fused two-direction GRU scan
  (replaces ``tacotron_multispeaker_tpu/ops/gru_scan.py bigru_scan_pallas``;
  bf16 on the tensor cores, f32 on an FMA kernel, by ``fwd_route``),
  its backward ``bigru_scan_bwd`` (``_bigru_scan_bwd_pallas``: a carry-free
  prologue, ``bwd_remat``, then the gradient-only scan) and the autograd
  Function ``BiGRUScan`` joining them.
* :mod:`.decoder_loop` — ``decoder_loop``, the whole autoregressive decode
  (replaces ``tacotron_multispeaker_tpu/ops/decoder_loop.py
  decoder_loop_pallas``).
* :mod:`.teacher_decoder` — the teacher-forced decoder scan: forward
  (``_teacher_decoder_fwd_pallas``), backward (``_teacher_decoder_bwd_pallas``),
  d_keys (``_dkeys_pallas``) and the autograd Function ``TeacherDecoder``.
* :mod:`.cluster_plan` — the cluster size of the kernels that run a batch
  row on a thread-block cluster (the decoder loop, the teacher-forced
  forward, the attention step).
* :mod:`.wgrad` — the weight-gradient reduction of both backward kernels
  (the per-step ``dot_tn`` sums inside the two Pallas backward kernels).
* :mod:`.conv_bank` — ``conv_bank``, the CBHG conv bank as one product
  (``conv_bank_pallas``; ``parallel.use_pallas``, inference only).
* :mod:`.attention_step` — ``attention_step``, one additive-attention step
  with an optional location term (``attention_step_pallas``; the per-step
  decode under ``parallel.use_pallas``), and ``attention_step_partial``,
  its per-shard half (``attention_step_partial``; the sequence-sharded
  decode): one kernel, a batch row over a thread-block cluster split along
  L.
* :mod:`.overlap_add` — the plain static-shift overlap-add of the
  Griffin-Lim loop, and ``overlap_add``, the OLA kernel
  (``overlap_add_pallas``; ``dft_f32``/``dft_hi`` under
  ``parallel.use_pallas``, on prewindowed window-support frames).
* :mod:`.gl_iteration` — ``gl_fast_iterations``, every fast bf16
  Griffin-Lim iteration from one call (``gl_fast_iterations_pallas``;
  ``dft_bf16``/``dft_mix`` under ``parallel.use_pallas``).
"""

KERNELS = ("bigru_scan", "bigru_scan_bwd", "decoder_loop", "teacher_decoder_fwd",
           "teacher_decoder_bwd", "dkeys", "wgrad", "conv_bank", "attention_step",
           "overlap_add", "gl_iteration")
