"""Training across processes (port of uc2_tpu/parallel/): ``multihost``
starts the process group and holds the object and store collectives,
``mesh`` the process grid and the data-parallel parameter, gradient and
optimizer-state rules, ``tensor`` tensor parallelism over a model group."""
