"""Static HTML gallery writer (the JAX package's ``utils/html.py``): plain
string templating, images under ``{web_dir}/images``."""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence

from dfmir_tpu_torch.utils.util import mkdirs


class HTML:
    """Accumulates headers and image-table rows, then writes index.html.

    ``add_images`` takes paths relative to ``{web_dir}/images``."""

    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.refresh = refresh
        self._body: List[str] = []
        mkdirs([self.web_dir, self.img_dir])

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self._body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 400) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                '<td style="word-wrap:break-word" halign="center" '
                'valign="top"><p>'
                f'<a href="images/{link}">'
                f'<img style="width:{width}px" src="images/{im}"></a><br>'
                f'{_html.escape(str(txt))}</p></td>'
            )
        self._body.append(
            '<table border="1" style="table-layout:fixed">'
            "<tr>" + "".join(cells) + "</tr></table>"
        )

    def save(self) -> None:
        meta = ""
        if self.refresh > 0:
            meta = f'<meta http-equiv="refresh" content="{self.refresh}">'
        doc = (
            "<!DOCTYPE html><html><head>"
            f"<title>{_html.escape(self.title)}</title>{meta}</head><body>"
            + "".join(self._body) + "</body></html>"
        )
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)
