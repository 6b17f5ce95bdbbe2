"""The port's command line (cli, __main__, io, oracle) on the CPU: PNG in,
disparity PNG out, flag-compatible with the JAX package's CLI.  Twins of
tests/test_cli.py's cases, run with main(argv, device="cpu"), plus the
native oracle through --oracle (its maps equal the JAX binding's), the
refusal to run the engine without a card, a profiler trace, and --help
without jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from crossscalepatchmatch_tpu import oracle as joracle
from crossscalepatchmatch_tpu_torch import CostMethod, CSPMConfig
from crossscalepatchmatch_tpu_torch import io as cspm_io
from crossscalepatchmatch_tpu_torch import oracle
from crossscalepatchmatch_tpu_torch.cli import main
from crossscalepatchmatch_tpu_torch.data import (load_host_photo, make_pair,
                                                 photo_textures)
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_views(tmp_path, pair, right=None):
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    cspm_io.write_bgr(str(lp), pair.left)
    cspm_io.write_bgr(str(rp), pair.right if right is None else right)
    return str(lp), str(rp)


def read_gray(path):
    return np.asarray(Image.open(path))


def test_cli_roundtrip(tmp_path):
    """The CLI's maps are run_pair_np's on the config its flags make, byte
    for byte; --use_pallas is accepted and changes nothing."""
    pair = make_pair(h=64, w=96, max_dis=12, seed=3)
    lp, rp = write_views(tmp_path, pair)
    np.testing.assert_array_equal(cspm_io.read_bgr(lp), pair.left)
    lo, ro = str(tmp_path / "ld.png"), str(tmp_path / "rd.png")
    rc = main(["--l_img_file", lp, "--r_img_file", rp, "--l_dis_file", lo,
               "--r_dis_file", ro, "--max_dis", "12", "--dis_scale", "16",
               "--cc_name", "GRD", "--use_cs", "false", "--use_pp", "true",
               "--wnd_size", "15", "--reg_lambda", "0.0",
               "--use_pallas", "false"], device="cpu")
    assert rc == 0
    dis = read_gray(lo)
    assert dis.shape == (64, 96)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, cost_method=CostMethod.GRD,
                     use_pp=True, wnd_size=15, use_pallas=False)
    want = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu")
    np.testing.assert_array_equal(dis, want["dis"][0])
    np.testing.assert_array_equal(read_gray(ro), want["dis"][1])
    bad = bad_pixel_rate(dis.astype(np.float32) / 16.0, pair.disp_left,
                         pair.valid_left)
    assert bad < 0.15, bad


def test_cli_photo_textured_pair(tmp_path):
    """The CLI on a photograph-textured pair (matplotlib's grace_hopper.jpg
    crops as layer textures over exact geometry), census cost."""
    photo = load_host_photo()
    if photo is None:
        pytest.skip("no host photo available")
    h, w, md = 64, 96, 12
    texs = photo_textures(photo, 4, h, w + md + 4, np.random.default_rng(5))
    pair = make_pair(h=h, w=w, max_dis=md, seed=3, textures=texs)
    lp, rp = write_views(tmp_path, pair)
    lo, ro = str(tmp_path / "ld.png"), str(tmp_path / "rd.png")
    rc = main(["--l_img_file", lp, "--r_img_file", rp, "--l_dis_file", lo,
               "--r_dis_file", ro, "--max_dis", "12", "--dis_scale", "16",
               "--cc_name", "CEN", "--use_cs", "false", "--use_pp", "true",
               "--wnd_size", "15", "--reg_lambda", "0.0"], device="cpu")
    assert rc == 0
    bad = bad_pixel_rate(read_gray(lo).astype(np.float32) / 16.0,
                         pair.disp_left, pair.valid_left)
    assert bad < 0.15, bad


def test_cli_input_list(tmp_path, capsys):
    """Batch mode: a reference-style input.txt of flag lines (quoted
    values, a blank line, a leading binary token) runs every line."""
    pair = make_pair(h=48, w=64, max_dis=8, seed=2)
    lp, rp = write_views(tmp_path, pair)
    lst = tmp_path / "input.txt"
    lst.write_text(
        f'--l_img_file="{lp}" --r_img_file="{rp}" '
        f'--l_dis_file="{tmp_path}/a_l.png" --r_dis_file="{tmp_path}/a_r.png" '
        f'--max_dis=8 --dis_scale=16 --cc_name="GRD" --use_cs=false '
        f'--use_pp=false --wnd_size=11\n'
        f'\n'
        f'CSPM.exe --l_img_file={lp} --r_img_file={rp} '
        f'--l_dis_file={tmp_path}/b_l.png --r_dis_file={tmp_path}/b_r.png '
        f'--max_dis=8 --dis_scale=16 --cc_name=GRD --use_cs=false '
        f'--use_pp=false --wnd_size=11 --seed=1\n')
    assert main(["--input_list", str(lst)], device="cpu") == 0
    assert capsys.readouterr().out.count("Total Time: ") == 2
    a = read_gray(tmp_path / "a_l.png")
    b = read_gray(tmp_path / "b_l.png")
    assert a.shape == b.shape == (48, 64)
    assert not np.array_equal(a, b)        # seeds 0 and 1
    for m in (a, b):
        bad = bad_pixel_rate(m.astype(np.float32) / 16.0, pair.disp_left,
                             pair.valid_left)
        assert bad < 0.2, bad


def test_cli_shape_mismatch(tmp_path, capsys):
    pair = make_pair(h=32, w=48, max_dis=8, seed=1)
    lp, rp = write_views(tmp_path, pair, right=pair.right[:16])
    rc = main(["--l_img_file", lp, "--r_img_file", rp,
               "--l_dis_file", "x.png", "--r_dis_file", "y.png"],
              device="cpu")
    assert rc == 1 and "shapes differ" in capsys.readouterr().err
    assert main(["--l_img_file", lp, "--r_img_file", rp,
                 "--l_dis_file", "x.png"], device="cpu") == 1


def test_cli_oracle_matches_the_jax_binding(tmp_path, monkeypatch):
    """--oracle runs csrc/cspm_oracle.cc built by the port's own binding;
    its maps equal the JAX package's binding's on the same views."""
    pair = make_pair(h=32, w=48, max_dis=8, seed=4)
    lp, rp = write_views(tmp_path, pair)
    lo, ro = str(tmp_path / "ld.png"), str(tmp_path / "rd.png")
    rc = main(["--oracle", "--l_img_file", lp, "--r_img_file", rp,
               "--l_dis_file", lo, "--r_dis_file", ro, "--max_dis", "8",
               "--dis_scale", "16", "--wnd_size", "9", "--use_pp", "true",
               "--seed", "2"], device="cpu")
    assert rc == 0
    assert oracle.library_path().startswith(os.path.join(REPO, "build"))
    if joracle._lib is None:
        # the JAX binding builds into its own file, never the one another
        # test worker may be writing
        monkeypatch.setattr(joracle, "_LIB", str(tmp_path / "libj.so"))
    want = joracle.run_pair(pair.left, pair.right, max_dis=8, dis_scale=16,
                            wnd_size=9, use_pp=True, seed=2)
    np.testing.assert_array_equal(read_gray(lo), want[0])
    np.testing.assert_array_equal(read_gray(ro), want[1])


def test_oracle_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(oracle, "SRC", str(bad))
    monkeypatch.setattr(oracle, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="building the oracle failed"):
        oracle.build()
    assert os.listdir(tmp_path / "out") == []


def test_cli_without_a_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    """The engine runs on the card: with no CUDA device a run exits 1 with
    a message, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pair = make_pair(h=24, w=32, max_dis=6, seed=1)
    lp, rp = write_views(tmp_path, pair)
    lo = tmp_path / "ld.png"
    rc = main(["--l_img_file", lp, "--r_img_file", rp, "--l_dis_file",
               str(lo), "--r_dis_file", str(tmp_path / "rd.png")])
    assert rc == 1 and not lo.exists()
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_profile_dir_writes_a_trace(tmp_path):
    pair = make_pair(h=24, w=32, max_dis=6, seed=1)
    lp, rp = write_views(tmp_path, pair)
    prof = tmp_path / "prof"
    rc = main(["--l_img_file", lp, "--r_img_file", rp,
               "--l_dis_file", str(tmp_path / "ld.png"),
               "--r_dis_file", str(tmp_path / "rd.png"), "--max_dis", "6",
               "--dis_scale", "16", "--wnd_size", "5", "--max_iter", "1",
               "--exact_iters", "1", "--profile_dir", str(prof)],
              device="cpu")
    assert rc == 0
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_module_help_loads_no_jax():
    """python -m crossscalepatchmatch_tpu_torch --help prints the usage and
    loads neither jax nor the JAX package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['crossscalepatchmatch_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('crossscalepatchmatch_tpu_torch', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'crossscalepatchmatch_tpu')]\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--aggregator" in res.stdout and "--input_list" in res.stdout
    assert "LOADED []" in res.stdout
