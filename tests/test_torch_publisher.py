"""The port's publishing subsystem, on the CPU.

Every test of ``tests/test_publisher.py`` on ``veles_tpu_torch.
publishing``: the registry, the Markdown report with its plots, the PDF,
a custom jinja2 template, refusals, ``root.common.disable.publishing``,
the Confluence page posted to a local stub, one backend's failure not
stopping the others, no second fill of a plotter, duplicate unit names
and the Confluence gate.

Held to the JAX package: the same small MNIST workflow (same seeds,
provider and widths) trained two epochs by each package's eager
scheduler with the standard plot set; ``Publisher.gather_info()`` and
the default Markdown report equal once ids, times, pids, paths and the
config text (each package prints its own ``root``) are masked, the
workflow's description (each class's docstring) too, and floats compared
to 1e-5 relative (two float32 trainings that add in other orders). The
template is the JAX package's letter for letter. Without matplotlib the
publisher warns and gathers no plots; the package imports without
jinja2 and matplotlib (``tests/test_torch_observers.py``).
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jinja2")
pytest.importorskip("matplotlib")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.config import root as jax_root  # noqa: E402
from veles_tpu.models.mnist import MnistWorkflow as JaxMnist  # noqa: E402
from veles_tpu.publishing import Publisher as JaxPublisher  # noqa: E402
from veles_tpu.publishing import \
    jinja2_template_backend as jax_template  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.models.mnist import MnistWorkflow  # noqa: E402
from veles_tpu_torch.publishing import (Publisher,  # noqa: E402
                                        PublishingBackendRegistry,
                                        jinja2_template_backend)


def _provider():
    rng = numpy.random.RandomState(2)
    return (rng.rand(30, 6, 6).astype(numpy.float32),
            rng.randint(0, 10, 30).astype(numpy.int32),
            rng.rand(10, 6, 6).astype(numpy.float32),
            rng.randint(0, 10, 10).astype(numpy.int32))


def _trained(cls, package_prng, config, device):
    package_prng.get().seed(4)
    package_prng.get("loader").seed(5)
    wf = cls(provider=_provider, layers=(8,), minibatch_size=10,
             max_epochs=2)
    wf.initialize(device=device)
    wf.add_plotters()
    saved = config.common.disable.get("plotting", False)
    config.common.disable.update({"plotting": False})
    try:
        wf.run()
    finally:
        config.common.disable.update({"plotting": saved})
    return wf


@pytest.fixture(scope="module")
def trained_workflow():
    return _trained(MnistWorkflow, prng, root, "cpu")


@pytest.fixture(scope="module")
def trained_pair():
    """(port, JAX) workflows trained alike, for the parity tests alone:
    each Publisher made joins its workflow's units, and both sides must
    get the same ones."""
    return (_trained(MnistWorkflow, prng, root, "cpu"),
            _trained(JaxMnist, jax_prng, jax_root, Device(backend="cpu")))


def test_registry_has_all_backends():
    assert set(PublishingBackendRegistry.backends) >= {
        "markdown", "jinja2", "pdf", "confluence"}


def test_markdown_report(trained_workflow, tmp_path):
    wf = trained_workflow
    report = tmp_path / "report.md"
    pub = Publisher(wf, backends={"markdown": {"file": str(report)}})
    pub.initialize()
    pub.run()
    text = report.read_text()
    assert wf.name in text
    assert "## Results" in text
    assert "## Unit run times" in text
    assert "class lengths" in text
    assert "digraph" in text          # the workflow graph is embedded
    # plots were gathered and written next to the report
    pngs = list(tmp_path.glob("*.png"))
    assert pngs, "expected rendered plotter images"
    assert "![" in text


def test_pdf_report(trained_workflow, tmp_path):
    wf = trained_workflow
    report = tmp_path / "report.pdf"
    pub = Publisher(wf, backends={"pdf": {"file": str(report)}})
    pub.initialize()
    pub.run()
    blob = report.read_bytes()
    assert blob.startswith(b"%PDF")
    assert len(blob) > 1000


def test_jinja2_custom_template(trained_workflow, tmp_path):
    wf = trained_workflow
    out = tmp_path / "custom.txt"
    pub = Publisher(wf, backends={"jinja2": {
        "file": str(out),
        "template": "run {{ id }} of {{ name }}: "
                    "{{ results | length }} metrics"}})
    pub.initialize()
    pub.run()
    text = out.read_text()
    assert wf.name in text and "metrics" in text


def test_unknown_backend_rejected(trained_workflow):
    pub = Publisher(trained_workflow, backends={"nope": {}})
    with pytest.raises(ValueError, match="unknown publishing backend"):
        pub.initialize()


def test_disable_flag_skips_publishing(trained_workflow, tmp_path):
    report = tmp_path / "skipped.md"
    pub = Publisher(trained_workflow,
                    backends={"markdown": {"file": str(report)}})
    pub.initialize()
    saved = root.common.disable.get("publishing", False)
    root.common.disable.update({"publishing": True})
    try:
        pub.run()
    finally:
        root.common.disable.update({"publishing": saved})
    assert not report.exists()


def test_confluence_backend_posts_page(trained_workflow):
    pages = []

    class Stub(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            pages.append(json.loads(self.rfile.read(length)))
            body = json.dumps({"id": "12345"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = HTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        pub = Publisher(trained_workflow, backends={"confluence": {
            "server": "http://127.0.0.1:%d" % server.server_address[1],
            "space": "ML", "username": "u", "password": "p"}})
        pub.initialize()
        pub.run()
        assert len(pages) == 1
        page = pages[0]
        assert page["space"] == {"key": "ML"}
        assert trained_workflow.name in page["title"]
        assert "storage" in page["body"]
    finally:
        server.shutdown()
        server.server_close()


def test_backend_failure_does_not_abort_others(trained_workflow, tmp_path):
    ok = tmp_path / "ok.md"
    pub = Publisher(trained_workflow, backends={
        "jinja2": {"file": str(tmp_path / "broken.txt"),
                   "template": "{{ results | bogus_filter }}"},
        "markdown": {"file": str(ok)},
    })
    pub.initialize()
    pub.run()  # must not raise
    assert ok.exists()


def test_missing_file_kwarg_rejected(trained_workflow):
    pub = Publisher(trained_workflow, backends={"markdown": {}})
    with pytest.raises(ValueError, match="file"):
        pub.initialize()


def test_refill_does_not_duplicate_accumulated_points(trained_workflow,
                                                      tmp_path):
    wf = trained_workflow
    plotter = next(p for p in wf.plotters if hasattr(p, "values"))
    before = list(plotter.values)
    assert before, "fixture plotter accumulated during training"
    pub = Publisher(wf, backends={
        "markdown": {"file": str(tmp_path / "r.md")}})
    pub.initialize()
    pub.run()
    assert plotter.values == before  # no duplicate/erased points


def test_duplicate_unit_names_keep_all_rows(trained_workflow):
    pub = Publisher(trained_workflow, backends={})
    pub.initialize()
    stats = pub._run_times_by_unit()
    assert len(stats) == len(trained_workflow.units)


def test_confluence_backend_gated_without_server(trained_workflow):
    pub = Publisher(trained_workflow, backends={"confluence": {}})
    with pytest.raises(ValueError, match="gated"):
        pub.initialize()


# -- held to the JAX package ----------------------------------------------

def test_default_template_is_the_jax_packages():
    assert jinja2_template_backend.DEFAULT_TEMPLATE == \
        jax_template.DEFAULT_TEMPLATE


#: gather_info keys whose values are the run's own: ids, times, pids,
#: paths, the config text (each package's ``root``), the description
#: (each class's docstring) and the rendered plots (compared as sets of
#: names and formats)
MASKED = {"id", "logid", "pid", "days", "hours", "mins", "secs",
          "config_text", "description", "unit_run_times_by_name",
          "unit_run_times_by_class", "plots"}


def _close(got, want, path="info"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), path
    elif isinstance(want, numpy.generic):
        _close(got, want.item(), path)
    else:
        assert got == want, path


def _publishers(port_wf, jax_wf):
    pubs = []
    for cls, wf in ((Publisher, port_wf), (JaxPublisher, jax_wf)):
        pub = cls(wf, backends={})
        pub.initialize()
        pubs.append(pub)
    return pubs


def test_gather_info_equals_jax(trained_pair):
    port_pub, jax_pub = _publishers(*trained_pair)
    got, want = port_pub.gather_info(), jax_pub.gather_info()
    assert sorted(got) == sorted(want)
    _close({k: v for k, v in got.items() if k not in MASKED},
           {k: v for k, v in want.items() if k not in MASKED})
    for key in ("unit_run_times_by_name", "unit_run_times_by_class"):
        assert {k: v[1] for k, v in got[key].items()} == \
            {k: v[1] for k, v in want[key].items()}
    assert {k: sorted(v) for k, v in got["plots"].items()} == \
        {k: sorted(v) for k, v in want["plots"].items()}
    assert sorted(got["plots"]) == ["confusion", "train n_err_pt",
                                    "validation n_err_pt"]
    # the control: another run's results differ
    other = dict(want["results"], loss=want["results"]["loss"] * 1.01)
    with pytest.raises(AssertionError):
        _close(got["results"], other)


_NUMBER = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def _masked_report(text):
    """The report with the run's own lines masked: the id, log id, pid,
    elapsed, the description (its text sits between the title and the
    table), each unit's seconds, the config and graph blocks; floats
    rounded to 5 significant digits."""
    lines = text.split("\n")
    table = lines.index("| | |")
    lines = lines[:1] + ["<description>"] + lines[table:]
    out, skip = [], False
    for line in lines:
        if line.startswith("```"):
            skip = not skip if line == "```" or not skip else skip
            out.append(line[:3])
            continue
        if skip:
            continue
        if re.match(r"\| (run id|log id|pid|elapsed) \|", line):
            line = line.split("|")[1]
        elif re.match(r"\| .+ \| \d+\.\d{3} \| \d+ \|$", line):
            line = re.sub(r"\| \d+\.\d{3} \|", "| <s> |", line)
        out.append(_NUMBER.sub(
            lambda m: "%.5g" % float(m.group(0)), line))
    return "\n".join(out)


def test_markdown_report_equals_jax(trained_pair, tmp_path):
    reports = []
    for cls, wf, name in ((Publisher, trained_pair[0], "port"),
                          (JaxPublisher, trained_pair[1], "jax")):
        directory = tmp_path / name
        pub = cls(wf, backends={"markdown": {
            "file": str(directory / "report.md")}})
        pub.initialize()
        pub.run()
        reports.append((directory / "report.md").read_text())
        assert sorted(p.name for p in directory.glob("*.png")) == [
            "confusion.png", "train n_err_pt.png",
            "validation n_err_pt.png"]
    got, want = (_masked_report(r) for r in reports)
    assert got == want
    assert "| epochs | 2 |" in got


def test_without_matplotlib_no_plots(trained_workflow, monkeypatch,
                                     caplog):
    """matplotlib absent: the publisher warns, gathers no plots and the
    report renders all the same."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pub = Publisher(trained_workflow, backends={})
    pub.initialize()
    with caplog.at_level("WARNING"):
        info = pub.gather_info()
    assert info["plots"] == {}
    assert "matplotlib unavailable" in caplog.text
