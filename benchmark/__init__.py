"""The benchmark of the PyTorch port (``tacotron_multispeaker_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA devices of
this machine and prints one JSON result line.  Everything a cell needs is
found by name: its configuration in ``configs/``, its traffic mix in
``traffic/mixes/``, the driver the mix names in ``drivers/``, the limits of
its correctness check in ``limits/`` and one reader per per-layer metric in
``metrics/``.  ``reference/`` is the plain float32 model it is checked
against; ``counts/`` the operations, bytes and peaks behind its rooflines.
Nothing here imports JAX or the JAX package.
"""
