"""End-to-end benchmark of the PyTorch port on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once: it draws the cell's
weights on the card from the seed, serves them through the port's
``EngineServer`` over a ``TorchEngine``, drives ``POST /v1/completions``
(streamed) from a load generator in a child process, prints the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace 1``),
and checks the served tokens against the plain f32 reference in
``reference/``.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``cells/<cell>.json`` and
``metrics/<metric>.py``. Nothing here imports JAX or the JAX package.
"""
