"""COLMAP SfM runner (reference convert.py:31-144): feature extraction ->
exhaustive matching -> mapping -> undistortion, plus downsampled image sets.
COLMAP stays an external binary, exactly as in the reference. A copy of
``sdpgs_tpu/pipelines/convert.py``."""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path


def _run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise RuntimeError(f"command failed ({res.returncode}): {' '.join(cmd)}")


def convert_scene(
    source_path,
    colmap_executable: str = "colmap",
    camera_model: str = "OPENCV",
    use_gpu: bool = False,
    resize: bool = True,
    min_num_matches: int = 10,
) -> None:
    src = Path(source_path)
    db = src / "distorted" / "database.db"
    db.parent.mkdir(parents=True, exist_ok=True)

    _run([colmap_executable, "feature_extractor",
          "--database_path", str(db),
          "--image_path", str(src / "input"),
          "--ImageReader.single_camera", "1",
          "--ImageReader.camera_model", camera_model,
          "--SiftExtraction.use_gpu", str(int(use_gpu))])
    _run([colmap_executable, "exhaustive_matcher",
          "--database_path", str(db),
          "--SiftMatching.use_gpu", str(int(use_gpu))])
    (src / "distorted" / "sparse").mkdir(parents=True, exist_ok=True)
    _run([colmap_executable, "mapper",
          "--database_path", str(db),
          "--image_path", str(src / "input"),
          "--output_path", str(src / "distorted" / "sparse"),
          "--Mapper.ba_global_function_tolerance=0.000001",
          f"--Mapper.min_num_matches={min_num_matches}"])
    _run([colmap_executable, "image_undistorter",
          "--image_path", str(src / "input"),
          "--input_path", str(src / "distorted" / "sparse" / "0"),
          "--output_path", str(src),
          "--output_type", "COLMAP"])

    # sparse/* -> sparse/0/* (reference convert.py:106-117)
    sparse0 = src / "sparse" / "0"
    sparse0.mkdir(parents=True, exist_ok=True)
    for f in (src / "sparse").iterdir():
        if f.is_file():
            shutil.move(str(f), str(sparse0 / f.name))

    if resize:
        from PIL import Image

        for factor in (2, 4, 8):
            out = src / f"images_{factor}"
            out.mkdir(exist_ok=True)
            for img in (src / "images").iterdir():
                if img.suffix.lower() not in (".jpg", ".jpeg", ".png"):
                    continue
                im = Image.open(img)
                im.resize((im.width // factor, im.height // factor),
                          Image.LANCZOS).save(out / img.name)
