"""Several cards, one process each under ``torchrun`` (counterpart of
``pcgan_tpu/parallel``), with explicit collectives: ``mesh.py`` (the named
axes, their process groups, the hybrid mesh), ``train_parallel.py`` (the
data-parallel steps and the per-rank train state), ``auto.py`` (the
sharded-state step of ``--zero1``, the model axis and the spatial axis),
``spatial.py`` (activations split along H: the bands, the halo exchange,
the band sums), ``axis.py`` (the collectives over one axis and their
counters) and ``rows.py`` (a rank's rows of the global batch)."""
