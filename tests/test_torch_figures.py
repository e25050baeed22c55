"""Port vs reference: the paper's figures (``repro_torch.core.figures``) and
the report (``repro_torch.launch.report``), on ``device="cpu"``.

* twins of every test of ``tests/test_figures.py`` and of the three figure
  tests of ``tests/test_runtime.py`` (the partial-figure gap annotation, no
  partial meta on a complete figure, the journal resume directory);
* each smoke table equals the reference's ``build_figure(name, "smoke")``
  row for row, and its CSV is byte-equal to the committed
  ``docs/assets/<name>.smoke.csv``; the port's gallery equals the
  reference's once the module strings are mapped back, and its SVGs equal
  the reference's on the same install;
* the report writes under ``reports/torch/`` and never under ``docs/``;
  ``--check`` passes; a ``--figures`` subset or incomplete data in the
  default directory and flag misuse are refused as the reference refuses
  them.
"""

import hashlib
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core.figures as RF  # noqa: E402
from repro.launch import report as RR  # noqa: E402
from repro_torch.core import CampaignError  # noqa: E402
from repro_torch.core.figures import (FIGURES, SCALES,  # noqa: E402
                                      build_all, build_figure, figure_names,
                                      qualitative_checks)
from repro_torch.core import runtime as TR  # noqa: E402
from repro_torch.launch import report  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DEV = "cpu"
NAMES = ("jct-vs-load", "contention-cdf", "frag-timeline", "ocs-comparison",
         "real-trace", "hetero-interleave")


@pytest.fixture(scope="module")
def smoke_tables():
    return build_all("smoke", device=DEV)


@pytest.fixture(scope="module")
def reference_tables():
    return RF.build_all("smoke")


def _by_name(tables):
    return {t.name: t for t in tables}


def _docs_digest():
    return {str(p.relative_to(ROOT)): hashlib.sha256(p.read_bytes())
            .hexdigest()
            for p in sorted((ROOT / "docs").rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# twins of tests/test_figures.py
# ---------------------------------------------------------------------------

def test_registry_shape():
    names = figure_names()
    assert names == NAMES == RF.figure_names()
    for n in names:
        assert FIGURES[n].name == n


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown figure"):
        build_figure("nope", device=DEV)
    with pytest.raises(ValueError, match="unknown scale"):
        build_figure("jct-vs-load", scale="huge", device=DEV)
    assert "huge" not in SCALES


def test_unknown_name_message_is_the_reference_s():
    msgs = []
    for build in (build_figure, RF.build_figure):
        with pytest.raises(ValueError) as e:
            build("nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_same_seed_identical_tables(smoke_tables):
    again = build_figure("jct-vs-load", "smoke", device=DEV)
    assert again == _by_name(smoke_tables)["jct-vs-load"]


def test_tables_are_plain_scalars(smoke_tables):
    for t in smoke_tables:
        assert t.rows, t.name
        for r in t.rows:
            assert len(r) == len(t.columns)
            assert all(isinstance(v, (str, int, float)) for v in r)


def test_jct_vs_load_smoke_golden(smoke_tables):
    t = _by_name(smoke_tables)["jct-vs-load"]
    got = {(r[0], r[1]): r[2] for r in t.rows}
    assert got[("ecmp", 120.0)] == 5528.4
    assert got[("sr", 120.0)] == 4342.1
    assert got[("vclos", 120.0)] == 4071.7
    assert got[("best", 200.0)] == 4035.3


def test_ocs_comparison_smoke_golden(smoke_tables):
    t = _by_name(smoke_tables)["ocs-comparison"]
    got = {r[0]: (r[1], r[4]) for r in t.rows}
    assert got["ecmp"][0] == 13417.8
    assert got["sr"][0] == 3731.4
    assert got["ocs-vclos"] == (2957.9, 0)
    assert got["vclos"] == (3032.4, 2)


def test_contention_cdf_smoke_isolation(smoke_tables):
    t = _by_name(smoke_tables)["contention-cdf"]
    i_s, i_v = t.columns.index("strategy"), t.columns.index("slowdown")
    vclos = [r[i_v] for r in t.rows if r[i_s] == "vclos"]
    assert vclos and all(v == 1.0 for v in vclos)
    ecmp = [r[i_v] for r in t.rows if r[i_s] == "ecmp"]
    assert max(ecmp) > 1.5


def test_frag_timeline_smoke_golden(smoke_tables):
    t = _by_name(smoke_tables)["frag-timeline"]
    meta = t.meta_dict()
    assert meta["migrations[best (defrag)]"] == 3
    assert meta["migrations[best (no defrag)]"] == 0
    assert meta["mean_frag[ocs-relax (scattered)]"] == pytest.approx(
        0.617, abs=1e-4)
    assert meta["mean_frag[best (defrag)]"] < 0.15
    assert t.series_values() == ["best (defrag)", "best (no defrag)",
                                 "ocs-relax (scattered)"]


def test_real_trace_smoke_golden(smoke_tables):
    t = _by_name(smoke_tables)["real-trace"]
    meta = t.meta_dict()
    assert meta["format"] == "alibaba"
    assert meta["windows"] == 3
    assert meta["skipped"] == 5
    got = {r[0]: (r[1], r[5]) for r in t.rows}
    assert set(got) == {"vclos", "sr", "ecmp"}
    assert all(n == 25 for _, n in got.values())
    assert got["ecmp"][0] == 9041.0
    assert got["sr"][0] == 9025.5
    assert got["vclos"][0] == 11469.1


def test_hetero_interleave_smoke_golden(smoke_tables):
    t = _by_name(smoke_tables)["hetero-interleave"]
    meta = t.meta_dict()
    assert t.series_values() == ["affinity / homog", "affinity-time / homog",
                                 "affinity / hetero",
                                 "affinity-time / hetero"]
    assert meta["mean_jct[affinity / homog]"] == 1754.7
    assert meta["mean_jct[affinity-time / homog]"] == 1606.1
    assert meta["mean_jct[affinity / hetero]"] == 2330.2
    assert meta["mean_jct[affinity-time / hetero]"] == 2295.0
    assert meta["mean_jct[affinity / hetero]"] > \
        meta["mean_jct[affinity / homog]"]


def test_offset_aware_strictly_beats_offset_blind(smoke_tables):
    meta = _by_name(smoke_tables)["hetero-interleave"].meta_dict()
    for fleet in ("homog", "hetero"):
        aware = meta[f"mean_jct[affinity-time / {fleet}]"]
        blind = meta[f"mean_jct[affinity / {fleet}]"]
        assert aware < blind, fleet


def test_qualitative_orderings_hold(smoke_tables):
    assert qualitative_checks(smoke_tables) == []


def test_data_path_needs_no_matplotlib():
    """Building figures and their CSV / gallery with matplotlib
    import-blocked works, and rendering then reports False."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "from pathlib import Path\n"
        "from repro_torch.core.figures import build_figure\n"
        "t = build_figure('hetero-interleave', 'smoke', device='cpu')\n"
        "from repro_torch.launch.report import (csv_text, render_figure,\n"
        "                                       render_markdown)\n"
        "assert csv_text(t).startswith('variant,')\n"
        "assert 'affinity / homog' in render_markdown([t], 'smoke')\n"
        "assert render_figure(t, Path('unused.svg')) is False\n"
        "print('RENDERER_FREE_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert "RENDERER_FREE_OK" in r.stdout


def test_results_gallery_in_sync(smoke_tables):
    assert report.check_results(smoke_tables) == []


def test_csv_text_stable(smoke_tables):
    t = _by_name(smoke_tables)["jct-vs-load"]
    text = report.csv_text(t)
    assert text.splitlines()[0] == ",".join(t.columns)
    assert report.csv_text(t) == text


def test_render_figures_svg(tmp_path, smoke_tables):
    pytest.importorskip("matplotlib")
    for t in smoke_tables:
        out = tmp_path / f"{t.name}.svg"
        assert report.render_figure(t, out)
        head = out.read_text()[:200]
        assert out.stat().st_size > 1000 and "<?xml" in head, t.name


def test_render_is_deterministic(tmp_path, smoke_tables):
    pytest.importorskip("matplotlib")
    t = _by_name(smoke_tables)["ocs-comparison"]
    a, b = tmp_path / "a.svg", tmp_path / "b.svg"
    report.render_figure(t, a)
    report.render_figure(t, b)
    assert a.read_bytes() == b.read_bytes()


# ---------------------------------------------------------------------------
# twins of the figure tests of tests/test_runtime.py
# ---------------------------------------------------------------------------

def test_partial_figure_gap_annotation(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "raise@3")
    tab = build_figure("jct-vs-load", scale="smoke",
                       fault=dict(quarantine=True, max_retries=0,
                                  retry_backoff=0.0), device=DEV)
    meta = tab.meta_dict()
    assert meta["missing_cells"] == 1 and meta["failed_cells"] == 1
    assert meta["grid_cells"] == 8
    problems = qualitative_checks([tab])
    assert problems and "incomplete" in problems[0]
    assert qualitative_checks([tab], allow_partial=True) == []
    md = report.render_markdown([tab], "smoke")
    assert "Partial data" in md and "1 of 8 grid cells missing" in md


def test_complete_figure_has_no_partial_meta():
    tab = build_figure("ocs-comparison", scale="smoke", device=DEV)
    meta = tab.meta_dict()
    assert "missing_cells" not in meta and "failed_cells" not in meta


def test_figure_journal_resume_dir(tmp_path, monkeypatch, smoke_tables):
    monkeypatch.setenv("REPRO_CHAOS", "raise@3")
    with pytest.raises(CampaignError):
        build_figure("jct-vs-load", scale="smoke",
                     fault=dict(retry_backoff=0.0, max_retries=0),
                     resume_dir=str(tmp_path), device=DEV)
    assert (tmp_path / "jct-vs-load.journal.jsonl").exists()
    monkeypatch.delenv("REPRO_CHAOS")
    resumed = build_figure("jct-vs-load", scale="smoke",
                           resume_dir=str(tmp_path), device=DEV)
    assert resumed == _by_name(smoke_tables)["jct-vs-load"]


def test_figure_journal_crosses_packages(tmp_path, monkeypatch,
                                         smoke_tables):
    """A figure journal the reference left behind (one cell failed) is
    resumed by the port to the clean table."""
    monkeypatch.setenv("REPRO_CHAOS", "raise@3")
    from repro.core import CampaignError as ReferenceCampaignError
    with pytest.raises(ReferenceCampaignError, match="ChaosError"):
        RF.build_figure("jct-vs-load", scale="smoke",
                        fault=dict(retry_backoff=0.0, max_retries=0),
                        resume_dir=str(tmp_path))
    monkeypatch.delenv("REPRO_CHAOS")
    resumed = build_figure("jct-vs-load", scale="smoke",
                           resume_dir=str(tmp_path), device=DEV)
    assert resumed == _by_name(smoke_tables)["jct-vs-load"]


# ---------------------------------------------------------------------------
# the port against the reference and the committed gallery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_smoke_table_equals_the_reference(name, smoke_tables,
                                          reference_tables):
    ours = _by_name(smoke_tables)[name]
    theirs = _by_name(reference_tables)[name]
    assert ours.rows == theirs.rows
    for field in ("name", "title", "caption", "kind", "columns", "xcol",
                  "ycol", "series", "meta"):
        assert getattr(ours, field) == getattr(theirs, field), field


@pytest.mark.parametrize("name", NAMES)
def test_smoke_csv_equals_the_committed_csv(name, smoke_tables):
    committed = (ROOT / "docs" / "assets" / f"{name}.smoke.csv").read_bytes()
    assert report.csv_text(_by_name(smoke_tables)[name]).encode() \
        == committed


def test_gallery_equals_the_reference_after_mapping(smoke_tables,
                                                    reference_tables):
    ours = report.render_markdown(smoke_tables, "smoke")
    assert "python -m repro_torch.launch.report" in ours
    assert "src/repro_torch/core/figures.py" in ours
    theirs = RR.render_markdown(reference_tables, "smoke")
    assert ours != theirs
    assert report.as_reference(ours) == theirs
    assert report.as_reference(ours) == (ROOT / "docs" / "results.md") \
        .read_text()


@pytest.mark.parametrize("name", NAMES)
def test_svg_equals_the_reference_s(name, tmp_path, smoke_tables):
    pytest.importorskip("matplotlib")
    t = _by_name(smoke_tables)[name]
    ours, theirs = tmp_path / "port.svg", tmp_path / "reference.svg"
    assert report.render_figure(t, ours)
    assert RR.render_figure(t, theirs)
    assert ours.read_bytes() == theirs.read_bytes()


def test_series_colors_are_the_reference_s():
    assert report.SERIES_COLORS == RR.SERIES_COLORS


# ---------------------------------------------------------------------------
# where the report writes
# ---------------------------------------------------------------------------

@pytest.fixture
def built(monkeypatch, smoke_tables):
    """``generate`` on the already built smoke tables (no rebuild)."""
    def fake_build(scale, names, *args, **kwargs):
        tabs = [t for t in smoke_tables if names is None or t.name in names]
        return tabs
    monkeypatch.setattr(report, "_build", fake_build)


def test_generate_defaults_write_under_reports_torch(built):
    before = _docs_digest()
    doc = report.generate("smoke", progress=lambda _: None, device=DEV)
    assert doc == ROOT / "reports" / "torch" / "smoke" / "results.md"
    assets = doc.parent / "assets"
    for name in NAMES:
        assert (assets / f"{name}.smoke.csv").read_bytes() == \
            (ROOT / "docs" / "assets" / f"{name}.smoke.csv").read_bytes()
    assert report.as_reference(doc.read_text()) == \
        (ROOT / "docs" / "results.md").read_text()
    assert _docs_digest() == before


def test_no_path_writes_under_docs(built, monkeypatch, tmp_path):
    """Every write the report makes, on every path, lands outside docs/."""
    written = []
    write = TR.atomic_write_text

    def recording_write(path, text):
        written.append(Path(path).resolve())
        write(path, text)

    render = report.render_figure

    def recording_render(table, path):
        written.append(Path(path).resolve())
        return render(table, path)

    monkeypatch.setattr(TR, "atomic_write_text", recording_write)
    monkeypatch.setattr(report, "render_figure", recording_render)
    monkeypatch.setattr(report, "PAPER_OUT", tmp_path / "paper")
    before = _docs_digest()
    quiet = dict(progress=lambda _: None, device=DEV)
    report.generate("smoke", **quiet)
    report.generate("paper", render=False, **quiet)
    report.generate("smoke", out_dir=tmp_path / "out", **quiet)
    report.generate("smoke", out_dir=tmp_path / "sub",
                    names=("jct-vs-load",), **quiet)
    assert report.check_results(
        report._build("smoke", None, None, None)) == []
    assert written and not [p for p in written
                            if (ROOT / "docs") in p.parents]
    assert _docs_digest() == before


def test_subset_without_out_dir_is_refused(built):
    msgs = []
    for rep in (report, RR):
        with pytest.raises(SystemExit) as e:
            rep.generate("smoke", names=("jct-vs-load",),
                         progress=lambda _: None)
        msgs.append(str(e.value))
    assert "--figures subsets write into the default smoke gallery" \
        in msgs[0] and "pass --out-dir (or drop --figures)" in msgs[0]
    assert "pass --out-dir (or drop --figures)" in msgs[1]


def test_incomplete_data_in_the_default_directory_is_refused(
        monkeypatch, smoke_tables):
    import dataclasses
    partial = [dataclasses.replace(
        t, meta=tuple(sorted(t.meta + (("missing_cells", 1),
                                       ("failed_cells", 1),
                                       ("grid_cells", 8)))))
        if t.name == "jct-vs-load" else t for t in smoke_tables]
    monkeypatch.setattr(report, "_build", lambda *a, **k: partial)
    monkeypatch.setattr(RR, "_build", lambda *a, **k: partial)
    msgs = []
    for rep in (report, RR):
        with pytest.raises(SystemExit) as e:
            rep.generate("smoke", progress=lambda _: None,
                         allow_partial=True)
        msgs.append(str(e.value))
    for msg in msgs:
        assert "incomplete campaign data (jct-vs-load) cannot overwrite" \
            in msg
    # without allow_partial both refuse on the qualitative gate instead
    with pytest.raises(SystemExit, match="qualitative orderings"):
        report.generate("smoke", progress=lambda _: None)


def test_check_cli_passes(capsys):
    before = _docs_digest()
    report.main(["--check", "--device", DEV])
    assert capsys.readouterr().out.startswith("report-check: OK")
    assert _docs_digest() == before


@pytest.mark.parametrize("argv", [
    ["--figures", "nope"],
    ["--cell-timeout", "0"],
    ["--max-retries", "-1"],
    ["--resume", "FILE"],
    ["--check", "--scale", "paper"],
    ["--check", "--figures", "jct-vs-load"],
], ids=["figures", "cell-timeout", "max-retries", "resume-file",
        "check-paper", "check-figures"])
def test_cli_flag_misuse_as_the_reference(argv, tmp_path, monkeypatch,
                                          capsys):
    afile = tmp_path / "journal.jsonl"
    afile.write_text("")
    argv = [str(afile) if a == "FILE" else a for a in argv]
    errors = []
    for run in (lambda: report.main(argv + ["--device", DEV]),
                lambda: RR.main()):
        monkeypatch.setattr(sys, "argv", ["report"] + argv)
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    ours, theirs = (e.split("error: ", 1)[1] for e in errors)
    assert ours == theirs
