"""The port's live dashboard (``utils/plot_server.py``) against the JAX
package's ``start_plot_server`` on 127.0.0.1: the same experiment
directory served by both gives the same status, content type and body at
every endpoint (the page, the loss history with a torn last line, the
newest epoch's images, an image, refused paths), also after the history
grows and after it is rewritten shorter.  Then the port's ``Visualizer``
wiring: ``--display_id`` > 0 serves on ``--display_host`` /
``--display_port``, anything else serves nothing, a busy port warns and
training goes on."""

import argparse
import json
import urllib.error
import urllib.request

import pytest

from dfmir_tpu.utils.plot_server import start_plot_server as jax_start
from dfmir_tpu_torch.utils.plot_server import start_plot_server
from dfmir_tpu_torch.utils.visualizer import Visualizer
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

RECORDS = [{"epoch": 1, "counter_ratio": 0.5,
            "losses": {"G": 1.0, "R": 2.0, "total": 3.0}},
           {"epoch": 2, "counter_ratio": 0.25,
            "losses": {"G": 0.5, "R": 1.5, "total": 2.0}}]
PNG = b"\x89PNG\r\n\x1a\n" + b"\x00" * 16
PATHS = ["/", "/index.html", "/history", "/images",
         "/images/epoch002_fake_B.png", "/images/epoch001_real_A.png?t=3",
         "/images/not_an_epoch_image.png",
         "/images/..%2F..%2Floss_history.jsonl", "/images/epoch009_x.png",
         "/nope"]


@pytest.fixture()
def expr(tmp_path):
    d = tmp_path / "expt"
    img = d / "web" / "images"
    img.mkdir(parents=True)
    with open(d / "loss_history.jsonl", "w") as f:
        for r in RECORDS:
            f.write(json.dumps(r) + "\n")
        f.write('{"epoch": 3, "counter_')          # a torn tail write
    for name in ("epoch001_real_A.png", "epoch002_real_A.png",
                 "epoch002_fake_B.png", "not_an_epoch_image.png"):
        (img / name).write_bytes(PNG)
    return d


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture()
def servers(expr):
    started = [start(str(expr), "smoke <run>", port=0, host="127.0.0.1",
                     winsize=200) for start in (start_plot_server, jax_start)]
    yield expr, [f"http://127.0.0.1:{s.server_address[1]}"
                 for s, _ in started]
    for s, thread in started:
        s.shutdown()
        s.server_close()
        thread.join()


def same_everywhere(bases):
    for path in PATHS:
        mine, ref = (get(b + path) for b in bases)
        assert mine == ref, path
    return [json.loads(get(b + "/history")[2]) for b in bases][0]


def test_every_endpoint_equals_jax(servers):
    _, bases = servers
    assert same_everywhere(bases) == RECORDS
    status, ctype, page = get(bases[0] + "/")
    assert status == 200 and ctype.startswith("text/html")
    assert b"smoke &lt;run&gt;" in page and b"width: 200px" in page


def test_history_grows_and_restarts_as_jax(servers):
    expr, bases = servers
    same_everywhere(bases)
    hist = expr / "loss_history.jsonl"
    text = hist.read_text()
    extra = {"epoch": 3, "counter_ratio": 0.5, "losses": {"G": 0.25}}
    hist.write_text(text[:text.rindex("\n") + 1] + json.dumps(extra) + "\n"
                    + "not json\n")
    assert same_everywhere(bases) == RECORDS + [extra]
    hist.write_text(json.dumps(extra) + "\n")           # rewritten shorter
    assert same_everywhere(bases) == [extra]


def opt_for(tmp_path, **kw):
    base = dict(name="exp", checkpoints_dir=str(tmp_path), isTrain=True,
                no_html=False, display_winsize=128, display_id=None,
                display_port=0, display_host="127.0.0.1")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("display_id", [None, -1, 0])
def test_visualizer_serves_nothing_without_display_id(tmp_path, display_id):
    vis = Visualizer(opt_for(tmp_path, display_id=display_id))
    assert vis.plot_server is None
    vis.close()


def test_visualizer_serves_the_losses_it_logs(tmp_path):
    vis = Visualizer(opt_for(tmp_path, display_id=1))
    server, thread = vis.plot_server
    host, port = server.server_address[:2]
    assert host == "127.0.0.1" and thread.daemon
    vis.plot_current_losses(1, 0.5, {"G": 0.75, "NCE": 2.5})
    status, _, body = get(f"http://127.0.0.1:{port}/history")
    assert status == 200
    assert json.loads(body) == [{"epoch": 1, "counter_ratio": 0.5,
                                 "losses": {"G": 0.75, "NCE": 2.5}}]
    vis.close()
    assert vis.plot_server is None and not thread.is_alive()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2)


def test_busy_port_warns_and_goes_on(tmp_path, capsys):
    first = Visualizer(opt_for(tmp_path, display_id=1))
    port = first.plot_server[0].server_address[1]
    second = Visualizer(opt_for(tmp_path, display_id=1, display_port=port,
                                name="other"))
    assert second.plot_server is None
    assert "continuing without live display" in capsys.readouterr().out
    first.close()
