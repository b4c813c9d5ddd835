"""Data, sequence and tensor parallelism on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/``: one process per rank (the
PyTorch idiom, where JAX runs one controller over a mesh), named groups of a
rank mesh (``mesh.py``), the process group's start (``distributed.py``),
differentiable collectives (``comm.py``), a single-host launcher
(``launch.py``), and the SR model's and the stage-2 SAPF's sequence- and
tensor-parallel forwards and train steps (``sp.py``, ``tp.py``).
"""
