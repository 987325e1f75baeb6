from .gadgets import (  # noqa: F401
    AllocatedScalar, commitment_gadget, maybe_equal, range_check,
    min_bound, max_bound, scalar_decomposition_gadget,
)
