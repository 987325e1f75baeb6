# Submodules: metrics, config, checkpoint, profiling.
