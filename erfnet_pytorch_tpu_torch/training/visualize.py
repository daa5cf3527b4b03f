"""Dashboard — the counterpart of the JAX ``training/visualize.py`` (the
reference's ``train/visualize.py``): the visdom line and image plots of
``--visualize`` every ``--steps-plot`` steps.

``Dashboard`` takes, in order: the ``visdom`` package if it imports;
:class:`WireClient`, a stdlib ``urllib`` client of visdom's public
JSON-over-HTTP protocol (plotly traces and base64 PNG images POSTed to
``/events``), when a server answers on the port; else nothing, with one
message, so ``--visualize`` never stops a headless run.  A plot that
fails is reported; three failures in a row turn plotting off.
"""

from __future__ import annotations

import base64
import io
import json
import urllib.error
import urllib.request

import numpy as np


class WireClient:
    """Minimal visdom client speaking the public JSON-over-HTTP protocol.

    Implements exactly the two calls the reference dashboard uses
    (``train/visualize.py:≈1-25``): ``line`` and ``image``.  Payload shapes
    follow the public visdom client: plotly scatter traces for lines, and a
    base64-encoded PNG ``data:`` URI for images, POSTed as JSON to the
    server's ``/events`` endpoint with the window name in ``win`` and the
    environment in ``eid``.
    """

    def __init__(self, host: str = "localhost", port: int = 8097,
                 env: str = "main", timeout: float = 2.0):
        self.base = f"http://{host}:{port}"
        self.env = env
        self.timeout = timeout

    # -- transport ---------------------------------------------------------
    def _post(self, endpoint: str, payload: dict) -> str:
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            f"{self.base}/{endpoint}", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode("utf-8", errors="replace")

    def check_connection(self) -> bool:
        """True iff something HTTP-ish answers on the configured port."""
        try:
            req = urllib.request.Request(self.base, method="GET")
            urllib.request.urlopen(req, timeout=self.timeout)
            return True
        except urllib.error.HTTPError:
            return True  # server up, path just 404s — good enough
        except Exception:
            return False

    # -- plot calls (visdom-API-compatible subset) --------------------------
    def line(self, Y, X=None, win=None, opts=None) -> str:
        y = np.asarray(Y, dtype=np.float64).reshape(-1)
        x = (np.arange(y.size, dtype=np.float64) if X is None
             else np.asarray(X, dtype=np.float64).reshape(-1))
        opts = dict(opts or {})
        trace = {"x": x.tolist(), "y": y.tolist(), "type": "scatter",
                 "mode": "lines", "name": str(opts.get("title", win or ""))}
        layout = {"title": opts.get("title"),
                  "xaxis": {"title": opts.get("xlabel")},
                  "yaxis": {"title": opts.get("ylabel")}}
        return self._post("events", {"data": [trace], "win": win,
                                     "eid": self.env, "layout": layout,
                                     "opts": opts})

    def image(self, img, win=None, opts=None) -> str:
        """img: (3, H, W) or (H, W, 3) or (H, W), float [0,1] or uint8."""
        a = np.asarray(img)
        if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3):
            a = a.transpose(1, 2, 0)  # CHW (torch habit) -> HWC
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        if a.dtype != np.uint8:
            a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode("ascii")
        opts = dict(opts or {})
        data = [{"content": {"src": "data:image/png;base64," + b64,
                             "caption": opts.get("caption")},
                 "type": "image"}]
        return self._post("events", {"data": data, "win": win,
                                     "eid": self.env, "opts": opts})


class Dashboard:
    # consecutive post failures before plotting disables itself — a flaky
    # or restarting server must never stall (2 s timeout per plot) or
    # crash a multi-hour training run (the real visdom client likewise
    # swallows connection errors)
    _MAX_FAILURES = 3

    def __init__(self, port=8097, host="localhost"):
        self.vis = None
        self._ok = False
        self._failures = 0
        try:
            import visdom  # type: ignore
            self.vis = visdom.Visdom(port=port)
            self._ok = True
            return
        except Exception:
            pass
        wire = WireClient(host=host, port=port)
        if wire.check_connection():
            self.vis = wire
            self._ok = True
        else:  # pragma: no cover - depends on env
            print(f"[visualize] no visdom server on port {port}; "
                  "plots disabled")

    def _guard(self, fn, *args, **kwargs):
        """Run one plot call; never let a transport hiccup escape into
        the epoch loop."""
        try:
            fn(*args, **kwargs)
            self._failures = 0
        except Exception as e:  # pragma: no cover - transport-dependent
            self._failures += 1
            print(f"[visualize] plot failed ({e!r})")
            if self._failures >= self._MAX_FAILURES:
                print(f"[visualize] {self._failures} consecutive failures; "
                      "plots disabled for the rest of the run")
                self._ok = False

    def loss(self, losses, title):
        if not self._ok:
            return
        self._guard(self.vis.line, np.array(losses), win=title,
                    opts=dict(title=title))

    def image(self, image, title):
        """image: (H, W, 3) float in [0,1] or (3, H, W) — torch-habit safe."""
        if not self._ok:
            return
        img = np.asarray(image)
        if img.ndim == 3 and img.shape[-1] == 3:
            img = img.transpose(2, 0, 1)
        self._guard(self.vis.image, img, win=title, opts=dict(title=title))
