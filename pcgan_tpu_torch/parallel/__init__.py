"""Data parallelism across processes (counterpart of ``pcgan_tpu/parallel``):
one process per card under ``torchrun``, explicit collectives in the step
(``mesh.py``: the process group and its collectives; ``train_parallel.py``:
the data-parallel steps and the per-rank train state)."""
