"""Hand-written Hopper kernels of the port and their plain versions.

``attention.py`` holds the attention wrappers (chunk attention, fused paged
decode, the flash-attention backward's dq and dk/dv) and ``flash_attention``,
the autograd function over them; ``psgn.py`` the per-sample gradient-norm
wrappers (direct, gram, fused, and the bf16 split of their float32
operands) and ``ops.py`` their cost-model dispatch over
a layer or a tree of layers, and the int8 entry points; ``quant.py`` the
row-wise int8 quantisation of the gradient compressor; ``ref.py`` the
float32 plain versions the CPU runs and the kernels are held against,
``_build.py`` the nvcc build, and ``csrc/`` the CUDA sources.  :func:`launch_counts` reads every wrapper's
launch count, :func:`route_counts` the counts by route ("tc" tensor cores,
"fma" float32 FMA kernels, and for psgn direct and fused "split", float32
operands split into bf16 terms for the tensor cores) of the wrappers that
have several: the chunk forward, dq, dk/dv and the psgn wrappers.
"""

from repro_torch.kernels import attention, psgn, quant

_COUNTED = (attention.chunk_attention, attention.paged_decode_attention,
            attention.flash_dq, attention.flash_dkv,
            psgn.psgn_direct, psgn.psgn_gram, psgn.psgn_fused, psgn.psgn_split,
            quant.quantize_int8)


def reset_launch_counts() -> None:
    """Set every kernel's launch count, and the counts by route, to 0."""
    for fn in _COUNTED:
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def launch_counts() -> dict[str, int]:
    """``{wrapper name: kernel launches}`` for every kernel of the package."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def route_counts() -> dict[str, dict[str, int]]:
    """``{wrapper name: {route: launches}}`` for the chunk forward, dq, dk/dv
    ("tc", "fma") and the psgn wrappers (direct and fused also "split")."""
    return {fn.__name__: dict(fn.routes) for fn in _COUNTED if hasattr(fn, "routes")}
