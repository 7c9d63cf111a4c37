"""Data-parallel training across processes (port of uc2_tpu/parallel/):
``multihost`` starts the process group and holds the object and store
collectives, ``mesh`` the parameter, gradient and optimizer-state rules."""
