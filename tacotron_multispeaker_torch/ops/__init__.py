"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper runs its plain version for CPU tensors and launches its kernel
(``csrc/<name>.cu``, built at first use by :mod:`.cuda_build`) for CUDA
tensors, or raises; it never falls back.  Module-level ``*launches``
integers count the kernel launches.

* :mod:`.gru_scan` — ``bigru_scan``, the fused two-direction GRU scan
  (replaces ``tacotron_multispeaker_tpu/ops/gru_scan.py bigru_scan_pallas``),
  its backward ``bigru_scan_bwd`` (``_bigru_scan_bwd_pallas``) and the
  autograd Function ``BiGRUScan`` joining them.
* :mod:`.decoder_loop` — ``decoder_loop``, the whole autoregressive decode
  (replaces ``tacotron_multispeaker_tpu/ops/decoder_loop.py
  decoder_loop_pallas``).
* :mod:`.teacher_decoder` — the teacher-forced decoder scan: forward
  (``_teacher_decoder_fwd_pallas``), backward (``_teacher_decoder_bwd_pallas``),
  d_keys (``_dkeys_pallas``) and the autograd Function ``TeacherDecoder``.
* :mod:`.wgrad` — the weight-gradient reduction of both backward kernels
  (the per-step ``dot_tn`` sums inside the two Pallas backward kernels).
* :mod:`.overlap_add` — the plain overlap-add of the Griffin-Lim loop (no
  kernel: the JAX package runs the same plain formulation by default).
"""

KERNELS = ("bigru_scan", "bigru_scan_bwd", "decoder_loop", "teacher_decoder_fwd",
           "teacher_decoder_bwd", "dkeys", "wgrad")
