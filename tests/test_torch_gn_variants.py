"""``tools/gn_variants.py`` patches copies of the GN kernels' sources by
exact text.  These CPU tests hold each patch against the sources as they
stand, so that an edit to ``csrc/`` that moves a patched snippet shows
here and not first on a card."""
import importlib.util
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "gn_variants", ROOT / "tools" / "gn_variants.py")
gv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gv)


@pytest.mark.parametrize("name", list(gv.VARIANTS))
def test_gn_variant_patches_match_the_sources(name):
    """Each patch's text occurs once in its file and the patch changes
    it."""
    for f, old, new in gv.VARIANTS[name]:
        text = (gv.SRC / f).read_text()
        assert text.count(old) == 1, (name, f, old)
        assert text.replace(old, new) != text


def test_gn_variant_sources_and_entry_points_exist():
    """The files each variant builds and the C entry points it binds."""
    text = "".join((gv.SRC / f).read_text() for f in gv.SOURCES)
    for fn in gv.ENTRY_POINTS:
        assert f" {fn}(" in text, fn


def _old_source(f):
    """``f`` of ``csrc`` at ``OLD_COMMIT``, or None where the repository's
    history does not hold that commit."""
    try:
        return subprocess.run(
            ["git", "-C", str(ROOT), "show",
             f"{gv.OLD_COMMIT}:graphs4cfd_tpu_torch/csrc/{f}"],
            capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None


@pytest.mark.parametrize("name", list(gv.OLD_BF16_FWD))
def test_old_bf16_forward_patches_match_their_commit(name):
    """Each variant of the bf16 chain forward before its redesign patches
    text that occurs once in its file at ``OLD_COMMIT``, the sources it is
    built from."""
    for f, old, new in gv.OLD_BF16_FWD[name]:
        text = _old_source(f)
        if text is None:
            pytest.skip(f"the repository's history does not hold "
                        f"{gv.OLD_COMMIT}")
        assert text.count(old) == 1, (name, f, old)
        assert text.replace(old, new) != text
