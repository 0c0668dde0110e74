"""Minimal static HTML gallery builder (the port's copy of
``tpuseg/evaluation/results_page.py``; reference ResultsPage:
utils/results_page.py:80-245). The same tables give the same bytes."""
from __future__ import annotations

import os


class ResultsPage:
    def __init__(self, experiment_name: str, html_filename: str):
        self.experiment_name = experiment_name
        self.html_filename = html_filename
        self.outdir = os.path.dirname(html_filename)
        self.items: list = []

    def add_table(self, img_label_pairs, table_heading: str = ""):
        """img_label_pairs: list of (relative_image_path, caption)."""
        self.items.append((table_heading, list(img_label_pairs)))

    def write_page(self):
        rows = []
        for heading, pairs in self.items:
            cells = "".join(
                f'<td align="center"><a href="{fn}">'
                f'<img src="{fn}" width="256"></a><br>{caption}</td>'
                for fn, caption in pairs)
            rows.append(
                f"<h3>{heading}</h3>\n<table border=1><tr>{cells}</tr></table>")
        html = (
            "<html><head><title>{t}</title></head><body>\n"
            "<h1>{t}</h1>\n{body}\n</body></html>\n"
        ).format(t=self.experiment_name, body="\n".join(rows))
        os.makedirs(self.outdir, exist_ok=True)
        # written whole and renamed: ranks that dump their shards into one
        # directory never leave a page that interleaves their writes
        tmp = f"{self.html_filename}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, self.html_filename)
