"""Rich rendering of framework objects: choice maps as address trees,
traces as summaries, generic pytrees with array abbreviations, as text
(``pformat`` / ``pprint``) and as self-contained collapsible HTML
(``render_html``, no dependencies). Counterpart of
``genjax_tpu/utils/pretty.py``: the same text for the same trees.

``pretty()`` installs ``_repr_html_`` on the Pytree base (and ChoiceMap /
Trace), so IPython / Jupyter display the HTML renderer; the text
renderers are always there through ``pformat``.

JAX's tracers have no counterpart in eager PyTorch; a tensor on the
``meta`` device (``to_shape_fn``) has a shape and no values, and renders
by its shape and dtype alone.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils._pytree as tpu_tree

__all__ = ["pformat", "pprint", "render_choice_map", "render_html", "pretty"]


def _is_tracer(v: Any) -> bool:
    """A value with a shape and no data: a ``meta`` tensor."""
    return isinstance(v, torch.Tensor) and v.device.type == "meta"


def _numpy(v: Any) -> np.ndarray:
    """``v`` as numpy, as ``jnp.asarray`` would hold it (Python floats
    and ints as float32 / int32, JAX's defaults)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, bool):
        return np.asarray(v)
    if isinstance(v, float):
        return np.asarray(v, np.float32)
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    return np.asarray(v)


def _abbrev(v: Any) -> str:
    """One-line array/scalar summary; a ``meta`` tensor by its shape and
    dtype only."""
    if _is_tracer(v):
        dtype = str(v.dtype).removeprefix("torch.")
        return f"Tracer{tuple(v.shape)}[{dtype}]"
    try:
        arr = _numpy(v)
    except (TypeError, ValueError, RuntimeError):
        return repr(v)
    if arr.dtype == object:
        return repr(v)
    if arr.ndim == 0:
        return f"{arr}"
    base = f"{arr.dtype}[{','.join(map(str, arr.shape))}]"
    if arr.size == 0 or not np.issubdtype(arr.dtype, np.number):
        return base
    try:
        lo, hi = np.nanmin(arr), np.nanmax(arr)
        return f"{base} ∈[{lo:.3g}, {hi:.3g}]"
    except (TypeError, ValueError):
        return base


def _mask_label(mask) -> str:
    """Mask summary with lane occupancy for array flags."""
    flag = mask.flag
    if _is_tracer(flag):
        return f"{_abbrev(mask.value)} [masked by {_abbrev(flag)}]"
    f = _numpy(flag)
    if f.ndim == 0:
        state = "active" if bool(f) else "INACTIVE"
        return f"{_abbrev(mask.value)} [{state}]"
    return (
        f"{_abbrev(mask.value)} [active {int(f.sum())}/{f.size} lanes]"
    )


def _switch_branch_labels(idx, n_branches: int) -> list[str]:
    """Per-branch annotations: which branch is live (scalar idx) or how
    many vmapped lanes each branch owns (array idx)."""
    if _is_tracer(idx):
        return [f"branch {i}:" for i in range(n_branches)]
    a = _numpy(idx)
    if a.ndim == 0:
        return [
            f"branch {i}:" + (" ← active" if int(a) == i else " (inactive)")
            for i in range(n_branches)
        ]
    return [
        f"branch {i}: ({int((a == i).sum())}/{a.size} lanes)"
        for i in range(n_branches)
    ]


def render_choice_map(chm, indent: int = 0) -> str:
    """Render a ChoiceMap as an address tree."""
    from genjax_torch.gfi.choice_map import (
        Choice, Empty, Filtered, Indexed, Or, Static, Switch,
    )
    from genjax_torch.gfi.mask import Mask

    pad = "  " * indent
    if isinstance(chm, Empty):
        return f"{pad}(empty)"
    if isinstance(chm, Choice):
        v = chm.v
        if isinstance(v, Mask):
            return f"{pad}{_mask_label(v)}"
        return f"{pad}{_abbrev(v)}"
    if isinstance(chm, Static):
        lines = []
        for k, sub in zip(chm.keys, chm.submaps):
            inner = render_choice_map(sub, indent + 1)
            lines.append(f"{pad}{k!r}:\n{inner}")
        return "\n".join(lines)
    if isinstance(chm, Indexed):
        inner = render_choice_map(chm.inner, indent + 1)
        if chm.idx is None:
            # Canonical arange lanes (Scan/Vmap choices).
            try:
                label = f"[i = 0..{chm._n() - 1}]"
            except Exception:
                label = "[i = lanes]"
        else:
            label = f"[idx {_abbrev(chm.idx)}]"
        return f"{pad}{label}:\n{inner}"
    if isinstance(chm, Switch):
        lines = [f"{pad}switch(idx={_abbrev(chm.idx)}):"]
        labels = _switch_branch_labels(chm.idx, len(chm.branches))
        for label, b in zip(labels, chm.branches):
            lines.append(f"{pad}  {label}")
            lines.append(render_choice_map(b, indent + 2))
        return "\n".join(lines)
    if isinstance(chm, Or):
        return (
            f"{pad}or (left wins at overlaps):\n"
            + render_choice_map(chm.left, indent + 1)
            + "\n"
            + render_choice_map(chm.right, indent + 1)
        )
    if isinstance(chm, Filtered):
        return (
            f"{pad}filtered by {type(chm.selection).__name__}:\n"
            + render_choice_map(chm.inner, indent + 1)
        )
    return f"{pad}{chm!r}"


def _leaves_with_path(obj: Any) -> list:
    """``(path, leaf)`` pairs, ``None`` an empty subtree as in JAX."""
    return [(p, v) for p, v in tpu_tree.tree_flatten_with_path(obj)[0]
            if v is not None]


def pformat(obj: Any) -> str:
    """Render a framework object (Trace / ChoiceMap / pytree) as text."""
    from genjax_torch.gfi.choice_map import ChoiceMap
    from genjax_torch.gfi.gfn import Trace

    if isinstance(obj, Trace):
        lines = [
            f"{type(obj).__name__}(",
            f"  gen_fn = {type(obj.get_gen_fn()).__name__}",
            f"  score  = {_abbrev(obj.get_score())}",
            f"  retval = {_abbrev(obj.get_retval())}",
            "  choices:",
            render_choice_map(obj.get_choices(), indent=2),
            ")",
        ]
        return "\n".join(lines)
    if isinstance(obj, ChoiceMap):
        return render_choice_map(obj)
    leaves_lines = []
    for path, leaf in _leaves_with_path(obj):
        keystr = tpu_tree.keystr(path)
        leaves_lines.append(f"  {keystr} = {_abbrev(leaf)}")
    return f"{type(obj).__name__}(\n" + "\n".join(leaves_lines) + "\n)"


def pprint(obj: Any) -> None:
    print(pformat(obj))


# ---------------------------------------------------------------------------
# HTML rendering (dependency-free; collapsible <details> trees)
# ---------------------------------------------------------------------------

_CSS = """
<style>
.gjx{font-family:ui-monospace,Menlo,Consolas,monospace;font-size:12px;
  line-height:1.5;color:#24292f}
.gjx details{margin-left:1em;border-left:1px solid #d0d7de;padding-left:.6em}
.gjx summary{cursor:pointer;color:#0550ae;font-weight:600}
.gjx .k{color:#953800}
.gjx .chip{background:#f6f8fa;border:1px solid #d0d7de;border-radius:4px;
  padding:0 .35em;margin-left:.3em;color:#57606a;white-space:nowrap}
.gjx .masked{opacity:.55}
.gjx .active{color:#1a7f37;font-weight:600}
.gjx .inactive{color:#8c959f}
.gjx svg{vertical-align:middle;margin-left:.4em}
</style>
"""


def _esc(s: str) -> str:
    import html

    return html.escape(str(s), quote=True)


def _spark_svg(a: np.ndarray, w: int = 120, h: int = 18) -> str:
    """Inline SVG sparkline for a 1-D numeric array (≤ 1024 points after
    striding)."""
    a = a.astype(np.float64).ravel()
    a = a[np.isfinite(a)]
    if a.size < 2:
        return ""
    stride = max(1, a.size // 256)
    a = a[::stride]
    lo, hi = a.min(), a.max()
    span = (hi - lo) or 1.0
    xs = np.linspace(0, w, a.size)
    ys = h - 1 - (a - lo) / span * (h - 2)
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    return (
        f'<svg width="{w}" height="{h}"><polyline points="{pts}" '
        f'fill="none" stroke="#0969da" stroke-width="1"/></svg>'
    )


def _html_array(v: Any) -> str:
    chip = f'<span class="chip">{_esc(_abbrev(v))}</span>'
    if _is_tracer(v):
        return chip
    try:
        a = _numpy(v)
    except (TypeError, ValueError, RuntimeError):
        return f"<span>{_esc(repr(v))}</span>"
    if a.ndim == 0:
        return f"<span>{_esc(_abbrev(v))}</span>"
    spark = ""
    if a.ndim == 1 and np.issubdtype(a.dtype, np.number) and a.size <= 65536:
        spark = _spark_svg(a)
    return chip + spark


def _details(summary: str, body: str, open_: bool = True) -> str:
    o = " open" if open_ else ""
    return f"<details{o}><summary>{summary}</summary>{body}</details>"


def _html_choice_map(chm) -> str:
    from genjax_torch.gfi.choice_map import (
        Choice, Empty, Filtered, Indexed, Or, Static, Switch,
    )
    from genjax_torch.gfi.mask import Mask

    if isinstance(chm, Empty):
        return '<div class="inactive">(empty)</div>'
    if isinstance(chm, Choice):
        v = chm.v
        if isinstance(v, Mask):
            return f'<div class="masked">{_esc(_mask_label(v))}</div>'
        return f"<div>{_html_array(v)}</div>"
    if isinstance(chm, Static):
        rows = [
            _details(
                f'<span class="k">{_esc(repr(k))}</span>',
                _html_choice_map(sub),
            )
            for k, sub in zip(chm.keys, chm.submaps)
        ]
        return "".join(rows)
    if isinstance(chm, Indexed):
        if chm.idx is None:
            try:
                label = f"lanes i = 0..{chm._n() - 1}"
            except Exception:
                label = "lanes"
        else:
            label = f"idx {_esc(_abbrev(chm.idx))}"
        return _details(label, _html_choice_map(chm.inner))
    if isinstance(chm, Switch):
        labels = _switch_branch_labels(chm.idx, len(chm.branches))
        rows = []
        for label, b in zip(labels, chm.branches):
            cls = (
                "active" if "← active" in label
                else ("inactive" if "(inactive)" in label else "")
            )
            rows.append(_details(
                f'<span class="{cls}">{_esc(label)}</span>',
                _html_choice_map(b),
                open_="(inactive)" not in label,
            ))
        return _details(
            f"switch(idx={_esc(_abbrev(chm.idx))})", "".join(rows)
        )
    if isinstance(chm, Or):
        return _details(
            "or (left wins at overlaps)",
            _html_choice_map(chm.left) + _html_choice_map(chm.right),
        )
    if isinstance(chm, Filtered):
        return _details(
            f"filtered by {type(chm.selection).__name__}",
            _html_choice_map(chm.inner),
        )
    return f"<div>{_esc(repr(chm))}</div>"


def _html_any(obj: Any) -> str:
    from genjax_torch.gfi.choice_map import ChoiceMap
    from genjax_torch.gfi.gfn import Trace

    if isinstance(obj, Trace):
        body = (
            f"<div>score {_html_array(obj.get_score())}</div>"
            f"<div>retval {_html_array(obj.get_retval())}</div>"
            + _details("choices", _html_choice_map(obj.get_choices()))
        )
        return _details(
            f"{_esc(type(obj).__name__)} "
            f'<span class="chip">{_esc(type(obj.get_gen_fn()).__name__)}'
            "</span>",
            body,
        )
    if isinstance(obj, ChoiceMap):
        return _details(_esc(type(obj).__name__), _html_choice_map(obj))
    # Generic pytree: group leaves by path.
    rows = []
    for path, leaf in _leaves_with_path(obj):
        rows.append(
            f'<div><span class="k">{_esc(tpu_tree.keystr(path))}</span> '
            f"{_html_array(leaf)}</div>"
        )
    return _details(_esc(type(obj).__name__), "".join(rows))


def render_html(obj: Any) -> str:
    """Self-contained collapsible HTML rendering of any framework object
    (Trace / ChoiceMap / Mask / pytree). No external dependencies; safe
    to embed in notebooks (``_repr_html_``) or save to a file."""
    return f'{_CSS}<div class="gjx">{_html_any(obj)}</div>'


def pretty() -> None:
    """Install rich rendering: ``_repr_html_`` on the Pytree base plus
    ChoiceMap / Trace, so IPython / Jupyter render the collapsible HTML;
    idempotent."""
    from genjax_torch.core.pytree import Pytree
    from genjax_torch.gfi.choice_map import ChoiceMap
    from genjax_torch.gfi.gfn import Trace

    for cls in (Pytree, ChoiceMap, Trace):
        cls._repr_html_ = render_html  # self passed as obj
