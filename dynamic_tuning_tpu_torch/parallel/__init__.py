"""Data-parallel training over processes (counterpart of
dynamic_tuning_tpu/parallel): ``multihost`` starts the process group from
the launcher's environment, ``mesh`` holds the reductions over the global
batch."""
