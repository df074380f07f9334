"""The port's dataset fetcher (``data/get_data.py``) against the JAX
package's ``GetData``, both served by one local ``http.server`` on
127.0.0.1: the same option listing, the same unpacked trees from a zip and
a tar.gz, the same warning for an existing directory and the same
refusals (an unknown technique, a path-traversal archive member)."""

import io
import os
import tarfile
import threading
import zipfile
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import pytest

from dfmir_tpu.data.get_data import GetData as JaxGetData
from dfmir_tpu_torch.data.get_data import GetData, _AnchorLister
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

INDEX = """<html><body>
<a href="maps.zip">maps.zip</a>
<a href="horse2zebra.tar.gz">horse2zebra.tar.gz</a>
<a href="evil.zip">evil.zip</a>
<a href="README.html">README.html</a>
<a href="notes.txt">notes.txt</a>
</body></html>"""


class QuietHandler(SimpleHTTPRequestHandler):
    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataserver")
    (root / "index.html").write_text(INDEX)
    zbuf = io.BytesIO()
    with zipfile.ZipFile(zbuf, "w") as z:
        for name in ("maps/trainA/im0.raw", "maps/trainB/im0.raw",
                     "maps/testA/sub/im1.raw"):
            z.writestr(name, name.encode() * 3)
    (root / "maps.zip").write_bytes(zbuf.getvalue())
    tbuf = io.BytesIO()
    with tarfile.open(fileobj=tbuf, mode="w:gz") as t:
        for name in ("horse2zebra/trainA/im0.raw",
                     "horse2zebra/testB/im2.raw"):
            info = tarfile.TarInfo(name)
            data = name.encode() * 5
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    (root / "horse2zebra.tar.gz").write_bytes(tbuf.getvalue())
    ebuf = io.BytesIO()
    with zipfile.ZipFile(ebuf, "w") as z:
        z.writestr("../evil.raw", b"x")
    (root / "evil.zip").write_bytes(ebuf.getvalue())
    httpd = HTTPServer(("127.0.0.1", 0),
                       partial(QuietHandler, directory=str(root)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def tree(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


@pytest.mark.parametrize("technique", ["cyclegan", "pix2pix"])
def test_list_options_equal_jax(server, technique):
    url = f"{server}/index.html"
    mine = GetData(technique, mirror_url=url, verbose=False).list_options()
    ref = JaxGetData(technique, mirror_url=url, verbose=False).list_options()
    assert mine == ref == ["maps.zip", "horse2zebra.tar.gz", "evil.zip"]


@pytest.mark.parametrize("dataset", ["maps.zip", "horse2zebra.tar.gz"])
def test_get_unpacks_as_jax(server, tmp_path, dataset):
    mine = GetData(mirror_url=server, verbose=False).get(
        str(tmp_path / "mine"), dataset=dataset)
    ref = JaxGetData(mirror_url=server, verbose=False).get(
        str(tmp_path / "ref"), dataset=dataset)
    assert os.path.relpath(mine, tmp_path / "mine") == os.path.relpath(
        ref, tmp_path / "ref")
    assert tree(mine) == tree(ref) and tree(mine)
    assert sorted(os.listdir(tmp_path / "mine")) == sorted(
        os.listdir(tmp_path / "ref"))              # the archive removed


def test_existing_dir_voids_download(server, tmp_path):
    (tmp_path / "maps").mkdir()
    with pytest.warns(UserWarning, match="already exists"):
        path = GetData(mirror_url=server, verbose=False).get(
            str(tmp_path), dataset="maps.zip")
    assert path == str(tmp_path / "maps") and os.listdir(path) == []


def test_refusals_equal_jax(server, tmp_path):
    for cls in (GetData, JaxGetData):
        with pytest.raises(ValueError, match="unknown technique"):
            cls(technique="nope")
        with pytest.raises(ValueError, match="unsafe archive member"):
            cls(mirror_url=server, verbose=False).get(
                str(tmp_path / cls.__module__), dataset="evil.zip")
    assert not (tmp_path / "evil.raw").exists()


def test_anchor_parser():
    p = _AnchorLister()
    p.feed('<a href="x.zip">a.zip</a><a name="no-href">b.zip</a>')
    assert p.anchors == ["a.zip"]
