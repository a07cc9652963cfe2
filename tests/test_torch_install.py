"""An installed port carries and builds its kernels. One wheel is built
from a temporary copy of the packaging files and both packages (with a
stale library planted under ``kernels/_build/``), then installed with
``pip install --target`` and made read-only:

- the wheel holds every source and header of ``kernels.SOURCES`` and
  ``kernels.HEADERS`` and every file of ``kernels/csrc/``, and nothing of
  ``_build/``;
- it declares the nine ``prd-torch-*`` scripts on the port's CLIs beside
  the JAX package's nine ``prd-*`` ones, unchanged;
- in a process outside the checkout, the installed copy builds (with
  ``test_torch_kernel_build.py``'s stand-in nvcc) into the user's cache,
  since its package directory is read-only, and into
  ``$PRD_TORCH_KERNEL_DIR`` when that is set, writing nothing into the
  package; it imports nothing of ``protein_redesign_tpu``;
- the CLIs' ``main()`` returns None from the command line, so a console
  script exits 0 after a run.
"""

import configparser
import json
import shutil
import stat
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_kernel_build import FAKE_NVCC  # noqa: E402

from protein_redesign_tpu_torch import kernels  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CLIS = ("train", "generate", "predict_batch_structure", "predict_batch_sequence",
        "preprocess_pdbbind", "serve", "convert_checkpoint", "export_params", "evaluate")
KERNELS = "protein_redesign_tpu_torch/kernels/"


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: at these sizes the test suite's parallel workers
    would otherwise oversubscribe the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for package in ("protein_redesign_tpu", "protein_redesign_tpu_torch"):
        shutil.copytree(REPO / package, src / package,
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))
    stale = src / KERNELS / "_build"
    stale.mkdir()
    (stale / "libprd_kernels_0000000000000000.so").write_bytes(b"stale")
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-cache-dir", "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "-w", str(tmp / "dist"), str(src)],
                   check=True, capture_output=True)
    (path,) = (tmp / "dist").glob("*.whl")
    return path


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    site = tmp_path_factory.mktemp("site")
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-cache-dir", "--no-deps",
                    "--no-index", "-q", "--target", str(site), str(wheel)], check=True,
                   capture_output=True)
    package = site / "protein_redesign_tpu_torch"
    modes = {p: p.stat().st_mode for p in [package, *package.rglob("*")]}
    for p, mode in modes.items():
        p.chmod(mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))
    yield site
    for p, mode in modes.items():
        p.chmod(mode)


def test_wheel_holds_every_kernel_source_and_no_build(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    csrc = {KERNELS + "csrc/" + p.name for p in (REPO / KERNELS / "csrc").iterdir()}
    listed = {KERNELS + "csrc/" + name for name in kernels.SOURCES + kernels.HEADERS}
    assert listed <= csrc
    assert csrc <= names, sorted(csrc - names)
    assert not [n for n in names if "_build" in n]


def test_wheel_declares_the_port_scripts_beside_the_jax_ones(wheel):
    with zipfile.ZipFile(wheel) as z:
        (entry,) = [n for n in z.namelist() if n.endswith(".dist-info/entry_points.txt")]
        parser = configparser.ConfigParser()
        parser.read_string(z.read(entry).decode())
    scripts = dict(parser["console_scripts"])
    for cli in CLIS:
        name = cli.replace("_", "-")
        assert scripts.pop(f"prd-torch-{name}") == f"protein_redesign_tpu_torch.cli.{cli}:main"
        assert scripts.pop(f"prd-{name}") == f"protein_redesign_tpu.cli.{cli}:main"
    assert not scripts


BUILD = """
import json, os, sys
from pathlib import Path
from unittest import mock

import protein_redesign_tpu_torch
from protein_redesign_tpu_torch import kernels

kernels.ctypes.CDLL = mock.MagicMock()
chosen = kernels.build_dir()
lib = kernels.build()
os.environ[kernels.KERNEL_DIR_ENV] = sys.argv[1]
kernels._LIBRARY = None
explicit = kernels.build()
print(json.dumps({
    "package": protein_redesign_tpu_torch.__file__, "chosen": str(chosen),
    "built": str(lib.path), "explicit": str(explicit.path),
    "seconds": [lib.build_seconds, explicit.build_seconds],
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "protein_redesign_tpu")),
}))
"""


def test_installed_copy_builds_outside_its_read_only_package(installed, tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    env = {"PATH": f"{bin_dir}:/usr/bin:/bin", "PYTHONPATH": str(installed),
           "HOME": str(tmp_path / "home"), "XDG_CACHE_HOME": str(tmp_path / "cache")}
    before = sorted(p.name for p in (installed / KERNELS).iterdir())
    out = subprocess.run([sys.executable, "-c", BUILD, str(tmp_path / "explicit")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.splitlines()[-1])
    assert Path(got["package"]).is_relative_to(installed)
    cache = tmp_path / "cache" / "protein_redesign_tpu_torch" / "kernels"
    assert Path(got["chosen"]) == cache
    name = f"libprd_kernels_{kernels._source_digest()}.so"  # the checkout's sources, same hash
    assert Path(got["built"]) == cache / name
    assert Path(got["explicit"]) == tmp_path / "explicit" / name
    assert all(s is not None for s in got["seconds"])
    assert sorted(p.name for p in (installed / KERNELS).iterdir()) == before
    assert got["jax"] == []


def test_command_line_main_returns_none(tmp_path, monkeypatch):
    """A console script exits with ``main()``'s value: from the command line
    (no ``argv``) the generate CLI returns None, so the script exits 0."""
    from test_torch_generate import ARGS, _checkpoint

    from protein_redesign_tpu_torch.cli import generate

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):  # main() sets these; keep them test-local
        monkeypatch.setenv(name, "0")
    _checkpoint(tmp_path / "ckpt")
    monkeypatch.setattr(sys, "argv", ["prd-torch-generate", "-c", str(tmp_path / "ckpt"),
                                      "-o", str(tmp_path / "out"), *ARGS])
    assert generate.main() is None
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "sample_ligand.sdf", "sample_protein.pdb", "sample_tmscores.txt"]
