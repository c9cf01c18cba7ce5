"""Every photogrammetrie command of run-scripts/*.sh through the port's CLI.

Each distinct flag set of the scripts (the reference's experiment matrix:
SIFT or ORB, BF or FLANN, three camera models, unordered, sequence or grid
pairs, with or without --sgm, with --dense --mesh --colored --stats
--artifacts but for fast-test.sh's defaults) runs on -Pdevice=cpu on the bundled insel images cut to
240x135, with the script's -Pimage/-Pout replaced and its positional
arguments ($1 sequence length, $2 grid row length) set to 2. Each run must
exit 0 and write the sparse cloud and, with --dense, the dense cloud and
the mesh; then the scripts' pcl-stats step (run-pcl-stats.sh) runs on each. The
geometry of these runs is held elsewhere (tests/test_torch_slice.py,
tests/test_torch_orb_cli.py, chip_smoke.py); this file holds that no flag
of the matrix is refused.
"""

import glob
import os
import re
import shlex

import cv2
import pytest
import torch

from sfm_mvs_pipeline_tpu_torch.cli.app import main as t_main

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSEL = os.path.join(ROOT, "sample_data", "insel")


def _flag_sets():
    """{flag tuple: first script using it} over the scripts' photogrammetrie
    commands (image, output and log-level flags aside)."""
    sets = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "run-scripts", "*.sh"))):
        for line in open(path).read().replace("\\\n", " ").splitlines():
            if not re.match(r"^python -m sfm_mvs_pipeline_tpu .*-Prun=photogrammetrie", line):
                continue
            argv = shlex.split(line.split("|")[0].replace("$1", "2").replace("$2", "2"))[3:]
            flags = tuple(sorted(a for a in argv if not a.startswith(("-Pimage=", "-Pout=",
                                                                        "-Ploglevel="))))
            sets.setdefault(flags, os.path.basename(path))
    return sets


FLAG_SETS = _flag_sets()


@pytest.fixture(scope="module")
def insel_small(tmp_path_factory):
    data = tmp_path_factory.mktemp("insel_small")
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        cv2.imwrite(str(data / name), cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA))
    return data


def test_the_matrix_is_covered():
    """The scripts hold 19 distinct flag sets (fast-test.sh's defaults and
    18 dense experiments) over both detectors, both matchers and all three
    camera models."""
    flat = [a.lower() for flags in FLAG_SETS for a in flags]
    assert len(FLAG_SETS) == 19, sorted(FLAG_SETS.values())
    for want in ("-pfeature-detector=orb", "-pfeature-detector=sift", "-pfeature-matcher=flann",
                 "-pfeature-matcher=bf", "-pcamera-model=distortion", "-pcamera-model=simple",
                 "--sgm", "-pfeature-gridlength=2"):
        assert want in flat, want


@pytest.mark.parametrize("flags", sorted(FLAG_SETS), ids=lambda f: FLAG_SETS[f])
def test_run_script_flags_run_on_cpu(insel_small, tmp_path, flags):
    out = tmp_path / "reconstruction"
    argv = ["-Prun=photogrammetrie", f"-Pimage={insel_small}", f"-Pout={out}", "-Ploglevel=4",
            "-Pdevice=cpu", *flags]
    assert t_main(argv) == 0
    dense = ["pointcloud_dense", "mesh_dense"] if "--dense" in flags else []
    for cloud in ["pointcloud_sparse", *dense]:
        base = out / cloud
        assert os.path.getsize(f"{base}.ply") > 0, cloud
        assert t_main(["-Prun=pcl-stats", f"-Pinput={base}.ply", f"-Pstats={base}.stats.csv",
                       f"-Pneighbors={base}.neighbors.csv", f"-Pquality={base}.quality.ply",
                       "-Ploglevel=4"]) == 0
        for ext in ("stats.csv", "neighbors.csv", "quality.ply"):
            assert os.path.getsize(f"{base}.{ext}") > 0, (cloud, ext)
