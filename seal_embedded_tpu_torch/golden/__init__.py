"""Pure-Python/NumPy golden model: the host-side bit-exactness oracle.

A copy of ``seal_embedded_tpu/golden/`` (importing that package runs
``seal_embedded_tpu/__init__.py``, which imports jax).  The modules are
unchanged apart from their docstrings; their ``..config`` imports resolve
to the port's copy of ``config.py``.  ``tests/test_torch_io.py`` holds
each function equal to its JAX-package original on seeded inputs.  The
API (secret keys from a seed, the public key's error), the adapter
(keygen, the special-prime key row, the CRT decrypt) and the tests use
them; nothing here touches a device.
"""
