# Submodules: metrics, config.
