"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package builds and loads nothing; ``_build`` compiles
``csrc/*.cu`` on the first launch. Each wrapper counts its kernel's
launches in this process (plain-version calls are not counted):
:func:`launch_counts` reads them all, :func:`reset_launch_counts` sets
them to 0.
"""


def _modules():
    from . import add_quantize, dct2d_fused, embed_epilogue, fold_pass
    from . import highest_read, luma_pass, luma_u8, read_tail, topk_select

    return {"k1": (luma_pass, "LAUNCHES"), "k1_pair": (luma_pass,
                                                       "PAIR_LAUNCHES"),
            "k1_high": (luma_pass, "HIGH_LAUNCHES"),
            "k4": (embed_epilogue, "LAUNCHES"),
            "k5": (read_tail, "LAUNCHES"),
            "k6a": (dct2d_fused, "FORWARD_LAUNCHES"),
            "k6b": (dct2d_fused, "INVERSE_LAUNCHES"),
            "k1f": (fold_pass, "LAUNCHES"),
            "k1f_high": (fold_pass, "HIGH_LAUNCHES"),
            "k7": (add_quantize, "LAUNCHES"),
            "k3": (topk_select, "LAUNCHES"),
            "k3_plane": (topk_select, "PLANE_LAUNCHES"),
            "k3_coeffs": (topk_select, "COEFF_LAUNCHES"),
            "k8": (luma_u8, "LAUNCHES"),
            "k9": (highest_read, "LAUNCHES")}


def launch_counts() -> dict:
    """Every kernel's launch count in this process, by its short name
    (``k1``, ``k1_pair``, ``k1_high``, ``k4``, ``k5``, ``k6a``, ``k6b``,
    ``k1f``, ``k1f_high``, ``k7``, ``k3``, ``k3_plane``, ``k3_coeffs``,
    ``k8``, ``k9``)."""
    return {k: getattr(m, a) for k, (m, a) in _modules().items()}


def reset_launch_counts() -> None:
    for m, a in _modules().values():
        setattr(m, a, 0)
