# Submodules: mesh, multihost, ntt_sharded, msm_sharded.
