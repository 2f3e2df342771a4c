import json
import os

import numpy as np
import pytest

from volumerenderingproject.harness import cli


def test_render_command(tmp_path):
    out = tmp_path / "r.png"
    rc = cli.main(
        [
            "render",
            "--data",
            "sphere",
            "--width",
            "16",
            "--height",
            "12",
            "--spr",
            "10",
            "--out",
            str(out),
        ]
    )
    assert rc == 0 and out.exists()
    from volumerenderingproject.utils import imageio

    img = imageio.load_png(out)
    assert img.shape == (12, 16, 3)


def test_render_default_name_matches_reference_format(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(
        ["render", "--data", "sphere", "--width", "8", "--height", "8", "--spr", "4"]
    )
    assert rc == 0
    assert os.path.exists("image_8x8_a1_spr4.png")  # myApp.cu:1209-1210 format


def test_info_command(capsys, avg152_path):
    rc = cli.main(["info", "--data", avg152_path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "SIZEOF_HDR: 540" in out
    assert "DIM: (3, 91, 109, 91" in out


def test_compare_self_is_perfect(tmp_path):
    out = tmp_path / "image_8x8_a1_spr4.png"
    cli.main(
        ["render", "--data", "sphere", "--width", "8", "--height", "8",
         "--spr", "4", "--out", str(out)]
    )
    rc = cli.main(
        ["compare", "--ours", str(out), "--golden", str(out), "--threshold", "0.99"]
    )
    assert rc == 0


def test_fit_command(tmp_path, capsys):
    out_tf = tmp_path / "tf.txt"
    rc = cli.main(
        [
            "fit",
            "--data",
            "sphere",
            "--width",
            "8",
            "--height",
            "8",
            "--spr",
            "8",
            "--steps",
            "2",
            "--out-tf",
            str(out_tf),
        ]
    )
    assert rc == 0 and out_tf.exists()
    from volumerenderingproject.scene.transfer_function import from_text

    tf = from_text(out_tf.read_text())
    assert tf.num_intervals == 4


def test_bench_command(capsys):
    rc = cli.main(
        ["bench", "--data", "sphere", "--width", "8", "--height", "8",
         "--spr", "4", "--repeats", "1"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "rays_per_sec_8x8_spr4" in out
    line = [l for l in out.splitlines() if l.startswith("{")][0]
    parsed = json.loads(line)
    assert parsed["unit"] == "rays/s" and parsed["value"] > 0


def test_config_json_roundtrip(tmp_path):
    from volumerenderingproject.utils.config import RenderConfig, Algorithm

    cfg = RenderConfig(width=32, height=16, samples_per_ray=8, lighting=True)
    p = tmp_path / "cfg.json"
    p.write_text(cfg.to_json())
    out = tmp_path / "o.png"
    rc = cli.main(
        ["render", "--data", "sphere", "--config", str(p), "--out", str(out)]
    )
    assert rc == 0
    from volumerenderingproject.utils import imageio

    assert imageio.load_png(out).shape == (16, 32, 3)
