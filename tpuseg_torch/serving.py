"""Model export for serving: ``torch.export`` programs in a bundle.

The port of ``tpuseg/serving.py``. ``export_model`` traces the eval
forward, ``model(x)["pred"].float()`` on a normalized NHWC image, with
``torch.export`` (weights carried as constants of the program) and saves
it with ``torch.export.save`` as a ``.pt2`` file. Both CUDA kernels are
registered ops (``tpuseg_torch::ocr_attention``,
``tpuseg_torch::bottleneck_fused``), so the exported graph holds each as one
node and a program exported on the card launches them when run there. The
fused bottleneck's folded weights and packed block are frozen into the
program (``Bottleneck.freeze_folded``).

    from tpuseg_torch.serving import export_model, load_exported
    export_model(model, (1024, 2048), "model.tpuseg_torch")
    serve = load_exported("model.tpuseg_torch")
    logits = serve(images)           # (B, H, W, num_classes) f32

An exported program is shape-specialized, so a bundle holds one entry per
(batch, H, W, dtype), listed in ``manifest.json``: pass a list of sizes, or
call ``export_model`` again on the same path, to add entries.
``load_exported`` returns one callable that dispatches on the input shape.
Re-exporting an entry replaces it; a path holding another format (a
``tpuseg`` StableHLO bundle among them) is refused, never clobbered.
Loading needs this package importable: ``load_exported`` imports
``tpuseg_torch.kernels``, which registers the two ops; the program runs on
the device it was exported on.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Callable

import numpy as np
import torch

_MAGIC = "tpuseg_torch-export-v1"


class _EvalForward(torch.nn.Module):
    """What a served call computes (tpuseg serving.py:36-41)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x)["pred"].float()


def _read_manifest(path: str) -> dict | None:
    fn = os.path.join(path, "manifest.json")
    if not os.path.isfile(fn):
        return None
    with open(fn) as f:
        manifest = json.load(f)
    if manifest.get("format") != _MAGIC:
        raise ValueError(
            f"{path} holds a {manifest.get('format')!r} artifact, not "
            f"{_MAGIC}; refusing to touch it")
    return manifest


@contextlib.contextmanager
def _frozen_kernel_weights(model: torch.nn.Module):
    """Every bottleneck block that may take the fused kernel carries its
    folded weights and packed block as buffers while the program is
    traced."""
    from tpuseg_torch.models.hrnet import Bottleneck

    blocks = [m for m in model.modules()
              if isinstance(m, Bottleneck) and m.fusable]
    with torch.no_grad():
        for m in blocks:
            m.freeze_folded()
    try:
        yield
    finally:
        for m in blocks:
            m.thaw_folded()


def _export_one(module, shape, dtype: str, device: torch.device,
                path: str) -> dict:
    example = torch.zeros(shape, dtype=getattr(torch, dtype), device=device)
    program = torch.export.export(module, (example,), strict=False)
    fname = "fn_" + "x".join(str(s) for s in shape[:3]) + f"_{dtype}.pt2"
    torch.export.save(program, os.path.join(path, fname))
    return {
        "file": fname,
        "input": {"shape": list(shape), "dtype": dtype},
        "device": device.type,
        "bytes": os.path.getsize(os.path.join(path, fname)),
    }


def export_model(model: torch.nn.Module, input_hw, path: str,
                 batch_size: int = 1, input_dtype: str = "bfloat16",
                 device: str = "cuda") -> dict:
    """Export ``model(x)["pred"].float()`` with the weights as constants,
    on ``device`` (the model is moved there and put in eval mode).

    ``input_hw``: one ``(h, w)`` pair or a sequence of pairs (multi-entry
    bundle). Returns the new entry dict for a single size, or the full
    manifest for several."""
    sizes = list(input_hw)
    if not hasattr(sizes[0], "__len__"):
        sizes = [sizes]
    dev = torch.device(device)
    model = model.to(dev).eval()
    os.makedirs(path, exist_ok=True)
    manifest = _read_manifest(path) or {
        "format": _MAGIC, "torch_version": torch.__version__, "entries": []}

    new_entries = []
    with _frozen_kernel_weights(model):
        module = _EvalForward(model)
        for hw in sizes:
            h, w = (int(s) for s in hw)
            shape = (batch_size, h, w, 3)
            entry = _export_one(module, shape, input_dtype, dev, path)
            # entries are keyed by (shape, dtype): re-exporting the same
            # key replaces it, another dtype at the same size coexists
            key = (shape, input_dtype)
            manifest["entries"] = [
                e for e in manifest["entries"]
                if (tuple(e["input"]["shape"]), e["input"]["dtype"]) != key
            ] + [entry]
            new_entries.append(entry)

    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return new_entries[0] if len(new_entries) == 1 else manifest


def load_exported(path: str) -> Callable:
    """-> callable(images) running the exported forward: ``images`` a
    tensor or numpy array (B, H, W, 3), the result an f32 tensor on the
    program's device. Validates the manifest and dispatches on the input
    shape across the bundle's entries; an input whose shape has only one
    entry is cast to that entry's dtype. The loaded ``ExportedProgram``s
    are kept as ``serve.programs``, one an entry."""
    import tpuseg_torch.kernels  # noqa: F401  (registers the ops)

    manifest = _read_manifest(path)
    if manifest is None:
        raise FileNotFoundError(f"no manifest.json under {path}")
    by_shape: dict = {}
    programs = []
    for entry in manifest["entries"]:
        program = torch.export.load(os.path.join(path, entry["file"]))
        programs.append(program)
        by_shape.setdefault(tuple(entry["input"]["shape"]), []).append(
            (getattr(torch, entry["input"]["dtype"]),
             torch.device(entry["device"]), program.module()))

    def serve(images):
        x = torch.as_tensor(images)
        shape = tuple(x.shape)
        if shape not in by_shape:
            raise ValueError(
                f"no entry exported for input {shape}; bundle has "
                f"{sorted(by_shape)}")
        candidates = by_shape[shape]
        # exact dtype match wins; a single-entry shape casts the input
        match = [c for c in candidates if c[0] == x.dtype]
        if not match and len(candidates) == 1:
            match = candidates
        if not match:
            raise ValueError(
                f"input dtype {x.dtype} matches none of the "
                f"{[str(c[0]) for c in candidates]} entries at {shape}")
        dtype, device, fn = match[0]
        with torch.inference_mode():
            return fn(x.to(device=device, dtype=dtype))

    serve.manifest = manifest
    serve.programs = programs
    return serve


def make_http_server(path: str, host: str = "0.0.0.0", port: int = 8000,
                     serve: Callable | None = None):
    """A stdlib inference server over an exported bundle (the protocol of
    ``tpuseg.serving.make_http_server``): the bundle at ``path`` loaded
    here, or ``serve``, the callable ``load_exported(path)`` returned (a
    load of a large bundle takes seconds). Returns an unstarted
    ThreadingHTTPServer; call ``serve_forever()`` (or use ``serve_http`` /
    ``python -m tpuseg_torch.cli serve``, which do).

    Protocol:
      GET  /healthz  -> 200, manifest JSON
      POST /predict  -> body: ``.npy``-serialized input batch (any entry's
                        shape); response: ``.npy`` f32 logits
                        (B, H, W, num_classes). 400 on a shape mismatch.
    """
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    fn = serve if serve is not None else load_exported(path)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet default stderr spam
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps(fn.manifest).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                out = fn(arr).cpu().numpy()
            except ValueError as e:
                self._send(400, str(e).encode(), "text/plain")
                return
            buf = io.BytesIO()
            np.save(buf, out, allow_pickle=False)
            self._send(200, buf.getvalue(), "application/octet-stream")

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.artifact_manifest = fn.manifest
    return httpd


def serve_http(path: str, host: str = "0.0.0.0", port: int = 8000):
    """Blocking entry: build the server and run it until interrupted
    (``python -m tpuseg_torch.cli serve --artifact <bundle> --port 8000``)."""
    httpd = make_http_server(path, host, port)
    print(f"tpuseg_torch serving {path} on {host}:{httpd.server_address[1]} "
          f"({len(httpd.artifact_manifest['entries'])} entries)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
