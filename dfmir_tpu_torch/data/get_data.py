"""Dataset fetcher (the JAX package's ``data/get_data.py``; the reference's
util/get_data.py:11-110).

Downloads a CycleGAN- or pix2pix-style archive from a dataset index page,
unpacks it under a target directory and returns the dataset root, with
the interactive option listing.  Beside the reference:

- the standard library only (urllib and html.parser), so it runs in a
  hermetic image and is tested against a local ``http.server``;
- archives stream to disk in chunks;
- extraction keeps every member under the destination (path-traversal
  entries are refused);
- ``mirror_url`` points it at an internal mirror without a subclass.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
from html.parser import HTMLParser
from os.path import abspath, basename, isdir, join
from warnings import warn
from zipfile import ZipFile

_URLS = {
    "pix2pix": "http://efrosgans.eecs.berkeley.edu/pix2pix/datasets/",
    "cyclegan": ("https://people.eecs.berkeley.edu/~taesung_park/"
                 "CycleGAN/datasets"),
}

_ARCHIVE_EXTS = (".zip", "tar.gz")


class _AnchorLister(HTMLParser):
    """Collects the text of <a href=...> elements (the index-page links)."""

    def __init__(self):
        super().__init__()
        self._in_a = False
        self._text = []
        self.anchors = []

    def handle_starttag(self, tag, attrs):
        if tag == "a" and any(k == "href" and v for k, v in attrs):
            self._in_a = True
            self._text = []

    def handle_data(self, data):
        if self._in_a:
            self._text.append(data)

    def handle_endtag(self, tag):
        if tag == "a" and self._in_a:
            self._in_a = False
            self.anchors.append("".join(self._text).strip())


class GetData:
    """Download a cyclegan/pix2pix dataset archive and unpack it.

    Example:
        >>> gd = GetData(technique="cyclegan")
        >>> path = gd.get(save_path="./datasets", dataset="maps.zip")
    """

    def __init__(self, technique: str = "cyclegan", verbose: bool = True,
                 mirror_url: str | None = None):
        self.url = mirror_url or _URLS.get(technique.lower())
        if self.url is None:
            raise ValueError(f"unknown technique {technique!r}; "
                             f"pick one of {sorted(_URLS)} or pass "
                             f"mirror_url")
        self._verbose = verbose

    def _print(self, text):
        if self._verbose:
            print(text)

    @staticmethod
    def _get_options(html_text: str):
        p = _AnchorLister()
        p.feed(html_text)
        return [a for a in p.anchors if a.endswith(_ARCHIVE_EXTS)]

    def list_options(self):
        """Archive names linked from the index page."""
        with urllib.request.urlopen(self.url) as r:
            return self._get_options(r.read().decode("utf-8", "replace"))

    def _present_options(self):
        options = self.list_options()
        print("Options:\n")
        for i, o in enumerate(options):
            print(f"{i}: {o}")
        choice = input("\nPlease enter the number of the "
                       "dataset above you wish to download:")
        return options[int(choice)]

    def _download_data(self, dataset_url: str, save_path: str):
        if not isdir(save_path):
            os.makedirs(save_path)
        base = basename(dataset_url)
        temp = join(save_path, base)
        with urllib.request.urlopen(dataset_url) as r, open(temp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)

        self._print("Unpacking Data...")
        if base.endswith(".tar.gz"):
            with tarfile.open(temp) as obj:
                obj.extractall(save_path, filter="data")
        elif base.endswith(".zip"):
            with ZipFile(temp, "r") as obj:
                dest = abspath(save_path)
                for name in obj.namelist():
                    if not abspath(join(dest, name)).startswith(dest):
                        raise ValueError(f"unsafe archive member {name!r}")
                obj.extractall(save_path)
        else:
            raise ValueError(f"Unknown File Type: {base}.")
        os.remove(temp)

    def get(self, save_path: str, dataset: str | None = None) -> str:
        """Fetch ``dataset`` (or prompt from the index) into ``save_path``;
        returns the absolute dataset root.  An existing root voids the
        download, as in the reference."""
        selected = dataset if dataset is not None else self._present_options()
        save_path_full = join(save_path, selected.split(".")[0])
        if isdir(save_path_full):
            warn(f"\n'{save_path_full}' already exists. Voiding Download.")
        else:
            self._print("Downloading Data...")
            self._download_data(f"{self.url.rstrip('/')}/{selected}",
                                save_path)
        return abspath(save_path_full)
