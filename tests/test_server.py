import json
import threading
import urllib.request

import numpy as np
import pytest

from volumerenderingproject.harness import server as srv
from volumerenderingproject.utils import imageio


@pytest.fixture(scope="module")
def running_server():
    httpd = srv.serve("sphere", port=0)  # ephemeral port
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_health(running_server):
    code, ctype, body = _get(running_server + "/health")
    assert code == 200 and ctype == "application/json"
    info = json.loads(body)
    assert info["status"] == "ok" and info["volume"] == [100, 100, 100]


def test_render_get(running_server):
    code, ctype, body = _get(
        running_server + "/render?width=16&height=16&spr=8&camera=default"
    )
    assert code == 200 and ctype == "image/png"
    img = imageio.decode_png(body)
    assert img.shape == (16, 16, 3)


def test_render_post(running_server):
    req = urllib.request.Request(
        running_server + "/render",
        data=json.dumps(
            {"width": 12, "height": 10, "spr": 6, "orbit": "45,0,0"}
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        img = imageio.decode_png(r.read())
    assert img.shape == (10, 12, 3)


def test_bad_requests(running_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(running_server + "/render?algorithm=bogus")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(running_server + "/nope")
    assert e.value.code == 404
    req = urllib.request.Request(
        running_server + "/render", data=b"not json",
        headers={"Content-Type": "application/json"},
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_viewer_page(running_server):
    code, ctype, body = _get(running_server + "/")
    assert code == 200 and ctype == "text/html"
    page = body.decode()
    # the reference's key map must be wired (processInput myApp.cu:1078-1241)
    for needle in ("keydown", "orbit", "image_", "/render?", "algorithm"):
        assert needle in page


def test_depth_param(running_server):
    code, ctype, png = _get(
        running_server + "/render?width=16&height=16&spr=8&depth=1")
    assert code == 200 and png[:4] == b"\x89PNG"
    arr = imageio.decode_png(png)
    # depth view is grayscale
    assert (arr[..., 0] == arr[..., 1]).all()
    assert (arr[..., 0] == arr[..., 2]).all()


def test_viewer_key_map_unique():
    """Every key handled by the viewer's keydown switch is bound exactly
    once (a duplicate binding makes the later branch dead code — the
    round-3 'b' bug), and the toggles named in the docstring key map are
    all reachable."""
    import re

    from volumerenderingproject.harness.viewer import VIEWER_HTML

    keys = re.findall(r'k === "(\w)"', VIEWER_HTML)
    assert len(keys) == len(set(keys)), f"duplicate key bindings: {keys}"
    # one key per state toggle (lighting/scattering/conic/depth)
    for toggle in ("state.lighting = 1", "state.scattering = 1",
                   "state.conic = 1", "state.depth = 1"):
        assert toggle in VIEWER_HTML
