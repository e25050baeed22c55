"""Paper-figure reproduction report: one command → CSVs + figures + gallery.

The port's copy of the reference's ``launch/report.py``.  Runs the
experiment specs of :mod:`repro_torch.core.figures` and emits, per figure, a
CSV (exact tabular data), an SVG rendering (matplotlib, headless — skipped
when matplotlib is not installed) and a **generated** markdown gallery with
the headline numbers inlined.

  PYTHONPATH=src python -m repro_torch.launch.report --scale smoke
  PYTHONPATH=src python -m repro_torch.launch.report --scale smoke --check
  PYTHONPATH=src python -m repro_torch.launch.report --scale paper

Every campaign cell and direct simulation resolves its rates on
``--device`` (default ``cuda``: the segment-max kernel, raising where there
is no card; ``cpu``: its plain version).  The tables are the same on both.

``--scale smoke`` writes ``reports/torch/smoke/results.md`` plus
``reports/torch/smoke/assets/<figure>.smoke.{csv,svg}`` and is
byte-deterministic: fixed seeds, pre-rounded tables, no timestamps.  Its
CSVs equal the committed ``docs/assets/<figure>.smoke.csv`` byte for byte,
and its gallery equals the committed ``docs/results.md`` once the two
module strings that name the port (:data:`MODULE_STRINGS`) are mapped back.
``--check`` regenerates the smoke suite in memory and holds it against
those committed files; it writes nothing.  Nothing here ever writes under
``docs/``: that gallery belongs to the reference.

``--scale paper`` runs the full suite (v2 engine, streaming aggregation,
the 2048-GPU CDF sweep) into ``reports/torch/paper/`` and fails loudly if
the reproduced data loses the paper's qualitative orderings
(:func:`repro_torch.core.figures.qualitative_checks`).

Shares its CLI plumbing (cluster presets, csv list args) with
``repro_torch.launch.sweep``.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import io
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[3]
# the reference's committed gallery: read by check_results, never written
RESULTS_DOC = ROOT / "docs" / "results.md"
SMOKE_ASSETS = ROOT / "docs" / "assets"
# where the port's report writes by default
SMOKE_OUT = ROOT / "reports" / "torch" / "smoke"
PAPER_OUT = ROOT / "reports" / "torch" / "paper"

#: the strings by which the port's gallery names its own modules, and the
#: reference's strings they map back to for the comparison with
#: ``docs/results.md``
MODULE_STRINGS = (("repro_torch.launch.report", "repro.launch.report"),
                  ("src/repro_torch/core/figures.py",
                   "src/repro/core/figures.py"))

# fixed entity → color map (categorical slots of the docs' reference
# palette, adjacent-validated order; color follows the strategy across
# every figure, never its rank within one chart)
SERIES_COLORS: Dict[str, str] = {
    "best": "#2a78d6", "ocs-vclos": "#eb6834", "vclos": "#1baf7a",
    "sr": "#eda100", "ecmp": "#e87ba4", "balanced": "#008300",
    "contention-affinity": "#4a3aa7", "ocs-relax": "#e34948",
    # frag-timeline variants (chart-local entities; first three slots
    # validate all-pairs)
    "best (defrag)": "#2a78d6", "best (no defrag)": "#eb6834",
    "ocs-relax (scattered)": "#1baf7a",
    # hetero-interleave variants: offset-blind in warm tones, offset-aware
    # in cool tones; hetero fleets darker than their homogeneous twins
    "contention-affinity-time": "#1baf7a",
    "affinity / homog": "#eda100", "affinity / hetero": "#e34948",
    "affinity-time / homog": "#2a78d6", "affinity-time / hetero": "#4a3aa7",
}
_FALLBACK_COLOR = "#52514e"
_TEXT = "#0b0b0b"
_TEXT_2 = "#52514e"
_SURFACE = "#fcfcfb"


# ---------------------------------------------------------------------------
# Serialisation: CSV + markdown (both byte-deterministic)
# ---------------------------------------------------------------------------

def _fmt(v) -> str:
    """One stable scalar formatting rule for CSV and markdown cells."""
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def csv_text(table) -> str:
    """The figure's rows as CSV text (``\\n`` line ends, stable floats)."""
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(table.columns)
    for r in table.rows:
        w.writerow([_fmt(v) for v in r])
    return buf.getvalue()


def _md_table(columns: Sequence[str], rows: Sequence[Sequence]) -> List[str]:
    out = ["| " + " | ".join(columns) + " |",
           "|" + "|".join("---" for _ in columns) + "|"]
    out += ["| " + " | ".join(_fmt(v) for v in r) + " |" for r in rows]
    return out


def _series_rows(table, value) -> List[Sequence]:
    i = table.columns.index(table.series)
    return [r for r in table.rows if r[i] == value]


def _cdf_summary(table) -> List[List[str]]:
    """Per-series slowdown quantiles from the long-form CDF rows."""
    iv = table.columns.index("slowdown")
    ifr = table.columns.index("cum_frac")
    out = []
    for s in table.series_values():
        rows = _series_rows(table, s)
        qs = []
        for q in (0.5, 0.9, 0.99):
            at = [r[iv] for r in rows if r[ifr] >= q]
            qs.append(_fmt(at[0]) if at else _fmt(rows[-1][iv]))
        out.append([s] + qs + [_fmt(max(r[iv] for r in rows))])
    return out


def _timeline_summary(table) -> List[List[str]]:
    meta = table.meta_dict()
    iv, it = table.columns.index("frag_index"), table.columns.index("t")
    out = []
    for s in table.series_values():
        rows = _series_rows(table, s)
        out.append([s, str(len(rows)),
                    _fmt(meta.get(f"mean_frag[{s}]", "")),
                    _fmt(max(r[iv] for r in rows)),
                    str(meta.get(f"migrations[{s}]", "")),
                    _fmt(rows[-1][it])])
    return out


def render_markdown(tables, scale: str, asset_prefix: str = "assets") -> str:
    """The gallery document.  Pure formatting over pre-rounded tables —
    regenerating from the same specs is byte-identical.  It differs from
    the reference's only in :data:`MODULE_STRINGS`."""
    L: List[str] = [
        "# Reproduced results gallery",
        "",
        "<!-- GENERATED FILE - do not edit by hand.",
        f"     Regenerate: python -m repro_torch.launch.report --scale {scale}",
        "     (make report).  scripts/docs_lint.py / make check fail when",
        "     this file drifts from a regenerated run. -->",
        "",
        f"Every figure below is generated from the experiment specs in "
        f"`src/repro_torch/core/figures.py` at **{scale}** scale by "
        f"`python -m repro_torch.launch.report --scale {scale}`.",
    ]
    if scale == "smoke":
        L += [
            "Smoke slices are seconds-fast, deterministic, and "
            "golden-pinned (`tests/test_figures.py`); the full experiment "
            "suite — v2 engine, streaming aggregation, the 2048-GPU CDF "
            "sweep — regenerates this gallery at paper scale with "
            "`python -m repro_torch.launch.report --scale paper` (see "
            "[reproduction.md](reproduction.md)).",
        ]
    L.append("")
    for t in tables:
        slug = f"{t.name}.{scale}"
        L += [f"## {t.title}", "",
              f"![{t.title}]({asset_prefix}/{slug}.svg)", "",
              t.caption, ""]
        meta_d = t.meta_dict()
        if meta_d.get("missing_cells"):
            # visible gap annotation: a partial campaign (quarantined /
            # never-run cells) renders, but never silently
            L += [f"> **⚠ Partial data** — {meta_d['missing_cells']} of "
                  f"{meta_d.get('grid_cells', '?')} grid cells missing "
                  f"({meta_d.get('failed_cells', 0)} quarantined).  Rows "
                  f"below pool only the surviving cells; resume the cell "
                  f"journal to fill the gaps (docs/robustness.md).", ""]
        if t.kind in ("line", "bar"):
            L += _md_table(t.columns, t.rows)
        elif t.kind == "cdf":
            L += _md_table(("strategy", "p50", "p90", "p99", "max"),
                           _cdf_summary(t))
        elif t.kind == "timeline":
            L += _md_table(("variant", "samples", "mean_frag", "peak_frag",
                            "migrations", "t_last"), _timeline_summary(t))
        meta = ", ".join(f"{k}={_fmt(v)}" for k, v in t.meta)
        L += ["",
              f"Data: [`{slug}.csv`]({asset_prefix}/{slug}.csv) - spec "
              f"`{t.name}` ({t.kind}); {meta}",
              ""]
    return "\n".join(L)


def as_reference(markdown: str) -> str:
    """The port's gallery with its module strings mapped to the
    reference's: what ``docs/results.md`` must equal."""
    for ours, theirs in MODULE_STRINGS:
        markdown = markdown.replace(ours, theirs)
    return markdown


# ---------------------------------------------------------------------------
# Matplotlib rendering (optional dependency, imported when rendering)
# ---------------------------------------------------------------------------

def _mpl():
    """``matplotlib.pyplot`` set up for deterministic SVGs, or None where
    matplotlib is not installed."""
    if importlib.util.find_spec("matplotlib") is None:
        return None
    import matplotlib
    matplotlib.use("Agg")
    # deterministic SVG output: fixed hashsalt, no embedded dates
    matplotlib.rcParams.update({
        "svg.hashsalt": "repro-results", "svg.fonttype": "path",
        "figure.facecolor": _SURFACE, "axes.facecolor": _SURFACE,
        "text.color": _TEXT, "axes.labelcolor": _TEXT_2,
        "xtick.color": _TEXT_2, "ytick.color": _TEXT_2,
        "axes.edgecolor": _TEXT_2, "axes.linewidth": 0.8,
        "axes.spines.top": False, "axes.spines.right": False,
        "axes.grid": True, "grid.color": "#e3e2de", "grid.linewidth": 0.6,
        "font.size": 9.5, "legend.frameon": False,
        "figure.figsize": (6.4, 3.4), "figure.dpi": 100,
    })
    import matplotlib.pyplot as plt
    return plt


def _color(series: str) -> str:
    return SERIES_COLORS.get(series, _FALLBACK_COLOR)


def render_figure(table, path: Path) -> bool:
    """Render one table to SVG.  Returns False when matplotlib is missing
    (the data path never depends on it)."""
    plt = _mpl()
    if plt is None:
        return False
    fig, ax = plt.subplots()
    ix = table.columns.index(table.xcol)
    iy = table.columns.index(table.ycol)
    if table.kind in ("line", "cdf", "timeline"):
        # linestyle cycle = secondary encoding, so coinciding curves
        # (best ≡ vclos, defrag ≈ no-defrag) stay individually visible
        styles = ("-", "--", "-.", ":", (0, (3, 1, 1, 1)))
        for k, s in enumerate(table.series_values()):
            rows = _series_rows(table, s)
            xs, ys = [r[ix] for r in rows], [r[iy] for r in rows]
            if table.kind == "cdf":
                ax.step(xs, ys, where="post", lw=2, color=_color(s), label=s,
                        linestyle=styles[k % len(styles)])
            else:
                ax.plot(xs, ys, lw=2, color=_color(s), label=s,
                        linestyle=styles[k % len(styles)],
                        marker="o", ms=4, markevery=max(1, len(xs) // 24))
        ax.legend(loc="best", fontsize=9)
        if table.name == "jct-vs-load":
            # smaller inter-arrival gap = heavier offered load: flip the
            # axis so load pressure grows to the right
            ax.invert_xaxis()
            ax.set_xlabel("mean inter-arrival λ (s) — heavier load →")
        else:
            ax.set_xlabel(table.xcol)
        ax.set_ylabel(table.ycol.replace("_", " "))
        if table.kind == "cdf":
            ax.set_ylabel("cumulative fraction of jobs")
            ax.set_xlabel("contention ratio (JRT / isolated JRT)")
    else:                                   # bar
        labels = [r[ix] for r in table.rows]
        ys = [r[iy] for r in table.rows]
        ax.bar(labels, ys, width=0.62, color=[_color(s) for s in labels],
               zorder=2)
        for x, y in zip(labels, ys):
            ax.annotate(_fmt(y), (x, y), ha="center", va="bottom",
                        fontsize=8.5, color=_TEXT_2, xytext=(0, 2),
                        textcoords="offset points")
        ax.set_ylabel(table.ycol.replace("_", " "))
        ax.grid(axis="x", visible=False)
    ax.set_title(table.title, fontsize=11, color=_TEXT, pad=10)
    fig.tight_layout()
    path.parent.mkdir(parents=True, exist_ok=True)
    # atomic: render into *.tmp and os.replace, so an interrupted run
    # never leaves a truncated SVG behind
    tmp = path.with_name(path.name + ".tmp")
    if path.suffix == ".svg":
        # deterministic bytes: svg.hashsalt is pinned and the Date field
        # (the only run-varying metadata) is stripped
        fig.savefig(tmp, format="svg", metadata={"Date": None})
    else:
        fig.savefig(tmp, format=path.suffix.lstrip(".") or None)
    os.replace(tmp, path)
    plt.close(fig)
    return True


# ---------------------------------------------------------------------------
# Generate / check
# ---------------------------------------------------------------------------

def _build(scale: str, names, workers, progress, engine=None, fault=None,
           resume_dir=None, device="cuda"):
    from ..core.figures import build_all
    return build_all(scale, names=names, workers=workers, progress=progress,
                     engine=engine, fault=fault, resume_dir=resume_dir,
                     device=device)


def generate(scale: str = "smoke", out_dir: Optional[Path] = None,
             names=None, workers: Optional[int] = None,
             render: bool = True, progress=print,
             engine: Optional[str] = None,
             fault: Optional[Dict] = None,
             resume_dir: Optional[Path] = None,
             allow_partial: bool = False,
             device: str = "cuda") -> Path:
    """Build the suite and write gallery + CSVs (+ SVGs).  Returns the
    gallery path.  Smoke defaults to ``reports/torch/smoke/``, paper to
    ``reports/torch/paper/``; ``docs/`` is never written.

    ``fault`` — SimConfig fault-policy overrides for the campaign-backed
    figures; ``resume_dir`` — directory of per-figure cell journals
    (created on first run, resumed on the next); ``allow_partial`` —
    render campaigns with quarantined/missing cells as a gallery with
    visible gap annotations instead of failing the qualitative gates;
    ``device`` — where every figure resolves its rates (``"cuda"`` or
    ``"cpu"``)."""
    from ..core.figures import qualitative_checks
    from ..core.runtime import atomic_write_text
    tables = _build(scale, names, workers, progress, engine, fault,
                    str(resume_dir) if resume_dir is not None else None,
                    device)
    problems = qualitative_checks(tables, allow_partial=allow_partial)
    if problems:
        raise SystemExit("[report] reproduced data lost the paper's "
                         "qualitative orderings:\n  - "
                         + "\n  - ".join(problems))
    incomplete = [t.name for t in tables
                  if t.meta_dict().get("missing_cells")]
    if out_dir is None:
        out_dir = SMOKE_OUT if scale == "smoke" else PAPER_OUT
        if scale == "smoke" and names is not None:
            # a partial suite must never leave the default smoke gallery
            # half-regenerated
            raise SystemExit(
                f"[report] --figures subsets write into the default smoke "
                f"gallery's assets ({out_dir / 'assets'}); pass --out-dir "
                f"(or drop --figures)")
        if scale == "smoke" and incomplete:
            # same rule for incomplete data: the default smoke gallery
            # stays a complete one
            raise SystemExit(
                f"[report] incomplete campaign data "
                f"({', '.join(incomplete)}) cannot overwrite the default "
                f"smoke gallery ({out_dir}); pass --out-dir (and resume "
                f"the journals to fill the gaps)")
    out_dir = Path(out_dir)
    doc, assets, prefix = out_dir / "results.md", out_dir / "assets", "assets"
    assets.mkdir(parents=True, exist_ok=True)
    for t in tables:
        atomic_write_text(assets / f"{t.name}.{scale}.csv", csv_text(t))
        if render:
            if not render_figure(t, assets / f"{t.name}.{scale}.svg"):
                progress("[report] matplotlib unavailable - SVGs skipped "
                         "(CSV/markdown still written)")
                render = False
    # partial-suite runs never overwrite a full gallery
    if names is None:
        doc.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(doc, render_markdown(tables, scale, prefix))
        progress(f"[report] gallery -> {doc}")
        if incomplete:
            progress(f"[report] WARNING: partial data in "
                     f"{', '.join(incomplete)} — gaps annotated in the "
                     f"gallery")
    else:
        progress(f"[report] partial suite ({', '.join(names)}): assets "
                 f"written, gallery untouched")
    return doc


def check_results(tables=None, workers: Optional[int] = None,
                  device: str = "cuda") -> List[str]:
    """Drift check behind ``--check``: regenerate the smoke suite (on
    ``device``) and hold it against the reference's committed
    ``docs/assets/*.smoke.csv`` (byte for byte) and ``docs/results.md``
    (after :func:`as_reference`).  Reads those files, never writes them.
    Returns error strings (empty = in sync)."""
    from ..core.figures import qualitative_checks
    errors: List[str] = []
    if tables is None:
        tables = _build("smoke", None, workers, None, device=device)
    errors += [f"figures: {p}" for p in qualitative_checks(tables)]
    want = as_reference(render_markdown(tables, "smoke"))
    if not RESULTS_DOC.exists():
        errors.append("docs/results.md missing - the reference's gallery "
                      "is the golden")
    elif RESULTS_DOC.read_text() != want:
        errors.append("docs/results.md differs from the port's smoke "
                      "gallery (module strings mapped) - the port "
                      "drifted from the reference")
    for t in tables:
        p = SMOKE_ASSETS / f"{t.name}.smoke.csv"
        if not p.exists():
            errors.append(f"docs/assets/{p.name} missing - the reference's "
                          f"CSV is the golden")
        elif p.read_text() != csv_text(t):
            errors.append(f"docs/assets/{p.name} differs from the port's "
                          f"table - the port drifted from the reference")
    return errors


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..core.config import ENGINES
    from ..core.figures import SCALES, figure_names
    from ..device import resolve_device
    from .sweep import csv_arg            # shared CLI plumbing
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.report",
        description="paper-figure reproduction report "
                    "(CSVs + SVGs + a generated results.md)")
    ap.add_argument("--scale", default="smoke", choices=SCALES)
    ap.add_argument("--figures", type=csv_arg(str), default=None,
                    metavar="NAME[,NAME...]",
                    help=f"subset of {', '.join(figure_names())} "
                         f"(default: all; subsets skip the gallery write)")
    ap.add_argument("--out-dir", default=None,
                    help="emit results.md + assets/ here instead of the "
                         "scale's default (smoke: reports/torch/smoke/, "
                         "paper: reports/torch/paper/)")
    ap.add_argument("--workers", type=int, default=None,
                    help="campaign cells across N processes "
                         "(bit-identical to serial)")
    ap.add_argument("--engine", default=None, choices=ENGINES,
                    help="simulator engine for the campaign cells "
                         "(default v2; batched runs qualifying serial "
                         "cells in lockstep — bit-identical schedules)")
    ap.add_argument("--no-render", action="store_true",
                    help="skip matplotlib SVGs (data + gallery only)")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="kill campaign cells running longer than this "
                         "(> 0; forces pool execution)")
    ap.add_argument("--max-retries", type=int, default=None, metavar="N",
                    help="extra attempts for crashed / timed-out / "
                         "transient cells (>= 0; default 2)")
    ap.add_argument("--quarantine", action="store_true",
                    help="skip permanently-failing cells and render with "
                         "visible gaps instead of aborting (implies "
                         "--allow-partial)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="journal each figure's campaign cells under DIR "
                         "and resume from existing journals there — "
                         "re-running after a crash skips finished cells "
                         "(bit-identical merge)")
    ap.add_argument("--allow-partial", action="store_true",
                    help="render incomplete campaigns (gap-annotated) "
                         "instead of failing the qualitative gates")
    ap.add_argument("--check", action="store_true",
                    help="regenerate the smoke suite in memory and fail on "
                         "any drift against the committed docs/ artifacts "
                         "(writes nothing)")
    ap.add_argument("--device", default="cuda",
                    help="where rate resolution runs: cuda (default; the "
                         "segment-max kernel, raises without a card) or "
                         "cpu (its plain version); tables are identical")
    args = ap.parse_args(argv)
    unknown = [n for n in (args.figures or ()) if n not in figure_names()]
    if unknown:
        ap.error(f"unknown figure(s) {', '.join(unknown)}; "
                 f"choose from {', '.join(figure_names())}")
    if args.cell_timeout is not None and args.cell_timeout <= 0:
        ap.error(f"--cell-timeout must be > 0 seconds "
                 f"(got {args.cell_timeout:g}); omit it to disable "
                 f"per-cell timeouts")
    if args.max_retries is not None and args.max_retries < 0:
        ap.error(f"--max-retries must be >= 0 (got {args.max_retries}); "
                 f"0 means a single attempt per cell")
    if args.resume is not None:
        rd = Path(args.resume)
        if rd.exists() and not rd.is_dir():
            ap.error(f"--resume {args.resume!r} is a file; the report "
                     f"keeps one journal per figure, so --resume takes a "
                     f"directory (use sweep campaign --resume for a "
                     f"single-journal campaign)")
        rd.mkdir(parents=True, exist_ok=True)
    device = str(resolve_device(args.device))
    if args.check:
        if args.scale != "smoke":
            ap.error("--check compares the committed smoke artifacts; "
                     "use --scale smoke")
        if args.figures is not None:
            ap.error("--check always verifies the full committed suite; "
                     "drop --figures")
        errors = check_results(workers=args.workers, device=device)
        if errors:
            print("report-check: FAILED")
            for e in errors:
                print(f"  - {e}")
            raise SystemExit(1)
        print("report-check: OK (docs/results.md + smoke CSVs in sync, "
              "orderings hold)")
        return
    fault = {k: v for k, v in (("cell_timeout", args.cell_timeout),
                               ("max_retries", args.max_retries),
                               ("quarantine", args.quarantine or None))
             if v is not None}
    generate(args.scale, Path(args.out_dir) if args.out_dir else None,
             names=args.figures, workers=args.workers,
             render=not args.no_render, engine=args.engine,
             fault=fault or None,
             resume_dir=Path(args.resume) if args.resume else None,
             allow_partial=args.allow_partial or args.quarantine,
             device=device)


if __name__ == "__main__":
    main()
