"""How the port is configured and installed:

- ``Settings`` reads a ``local.env`` in the working directory under the
  environment, as the JAX package's settings do (the environment wins);
- the CUDA kernels and the C++ CRAFT op build into the user's cache
  directory when their directory variables are unset, not into the package
  (an installed package is often read-only);
- the wheel ships every source the port builds at first use.
"""

import fnmatch
import tomllib
from pathlib import Path

import numpy as np

import surya_tpu_torch
from surya_tpu_torch import native
from surya_tpu_torch.ops import _build
from surya_tpu_torch.settings import Settings, load_dotenv

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(surya_tpu_torch.__file__).resolve().parent


def test_local_env_is_read_under_the_environment(tmp_path, monkeypatch):
    (tmp_path / "local.env").write_text(
        "# layout and table rec\n"
        "LAYOUT_BATCH_SIZE=7\n"
        "TABLE_REC_MAX_BOXES = '33'\n"
        "LAYOUT_SLICE_MIN={\"height\": 900, \"width\": 1000}\n"
        "not a setting line\n"
    )
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LAYOUT_BATCH_SIZE", raising=False)
    monkeypatch.delenv("LAYOUT_SLICE_MIN", raising=False)
    monkeypatch.setenv("TABLE_REC_MAX_BOXES", "44")
    assert load_dotenv()["TABLE_REC_MAX_BOXES"] == "33"
    s = Settings()
    assert s.LAYOUT_BATCH_SIZE == 7
    assert s.LAYOUT_SLICE_MIN == {"height": 900, "width": 1000}
    assert s.TABLE_REC_MAX_BOXES == 44  # the environment wins
    # an explicit mapping is read as it is
    assert Settings({}).LAYOUT_BATCH_SIZE is None


def test_no_local_env_gives_the_defaults(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name in ("LAYOUT_MAX_BOXES", "TABLE_REC_MAX_BOXES", "TABLE_REC_CELL_BATCH_MAX", "LAYOUT_PIPELINE_BATCH"):
        monkeypatch.delenv(name, raising=False)
    s = Settings()
    assert (s.LAYOUT_MAX_BOXES, s.TABLE_REC_MAX_BOXES, s.TABLE_REC_CELL_BATCH_MAX) == (100, 150, 128)
    assert s.LAYOUT_PIPELINE_BATCH is None


def test_build_dirs_default_outside_the_package(tmp_path, monkeypatch):
    monkeypatch.delenv("SURYA_TORCH_BUILD_DIR", raising=False)
    monkeypatch.delenv("SURYA_TORCH_NATIVE_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    for d in (_build.default_build_dir(), native.default_build_dir()):
        assert d.is_relative_to(tmp_path / "cache") and not d.resolve().is_relative_to(PACKAGE)
    # the C++ op really builds there, and nothing is written into the package
    before = sorted(p.relative_to(PACKAGE) for p in PACKAGE.rglob("*") if "__pycache__" not in p.parts)
    monkeypatch.setattr(native, "_lib", None)
    quads, _ = native.extract_boxes(np.pad(np.ones((6, 20), np.float32), 10), 0.5, 0.3)
    assert len(quads) == 1
    assert list(native.default_build_dir().glob("libcraft_ops_*.so"))
    after = sorted(p.relative_to(PACKAGE) for p in PACKAGE.rglob("*") if "__pycache__" not in p.parts)
    assert after == before


def test_package_data_ships_the_sources_built_at_first_use():
    with open(REPO / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)["tool"]["setuptools"]
    assert any(fnmatch.fnmatch("surya_tpu_torch", pat) for pat in project["packages"]["find"]["include"])
    patterns = project["package-data"]["surya_tpu_torch"]
    sources = [p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*") if p.suffix in (".cu", ".cuh", ".cpp")]
    assert {"csrc/flash_attn.cu", "csrc/decode_attn.cu", "csrc/common.cuh", "native/craft_ops.cpp"} <= set(sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, pat) for pat in patterns), f"{src} is not package data"
