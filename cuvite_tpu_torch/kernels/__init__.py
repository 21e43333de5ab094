"""The hand-written CUDA kernels and their plain PyTorch twins.

Each wrapper counts the launches of its kernel in its ``launches``
attribute (a launch on a CUDA tensor, never a twin call);
:func:`launch_counts` reads the counts (the row kernel's size form,
``row_argmax_sized``, has its own) and
:func:`zero_launch_counts` resets them.  :func:`form_counts` reads the
launches of each kernel form in the process (``_build.note_form``), and
:func:`new_forms` compares two readings.
"""

from cuvite_tpu_torch.kernels import _build


def _wrappers() -> dict:
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_sized,
    )
    from cuvite_tpu_torch.kernels.seg_coalesce import seg_coalesce

    return {"row_argmax": row_argmax, "heavy_bincount": heavy_argmax,
            "seg_coalesce": seg_coalesce,
            "row_argmax_sized": row_argmax_sized}


def launch_counts() -> dict:
    """Launches of each kernel since the counts were last zeroed."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def form_counts() -> dict:
    """Launches of each kernel form ``(kernel, body, card)`` since the
    process started (never zeroed: CUDA loads a body once a process)."""
    return dict(_build.FORMS)


def new_forms(before: dict, after: dict) -> list:
    """The forms that ``after`` counts and ``before`` never launched,
    sorted: the bodies CUDA first loaded between the two readings."""
    return sorted(k for k, n in after.items() if n and not before.get(k))
