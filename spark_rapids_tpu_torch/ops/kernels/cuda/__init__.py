"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port of
``spark_rapids_tpu/ops/kernels/pallas``.

One module per kernel family, each holding the wrapper (which launches
the kernel for CUDA tensors and bumps its ``launches`` count), the plain
PyTorch version (taken for CPU tensors, and the kernel's yardstick on
the card) and nothing else:

* :mod:`.join_probe` — ``joinProbe``, the direct-address join table;
* :mod:`.segmented` — ``segmented``, the sort-path group-by reductions;
* :mod:`.sort_steps` — ``sortStep``, the argsort of a packed single-key
  lane;
* :mod:`.strings` — ``strings``, the gather of flat-string char rows.

Sources are in ``csrc/``; :mod:`._build` compiles them with ``nvcc`` at
first use and loads them with ``ctypes``.
"""
