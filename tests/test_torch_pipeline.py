"""The port's offline experiment pipelines end to end on the CPU, with no
JAX importable: ``example/torch_dataset_pipeline.sh`` on generated libsvm
data (clean -> normalize -> sample -> the port's initial ranker -> ULTRA
prep -> the port's CLI trains and tests) and the toy
``example/toy/torch_offline_exp_pipeline.sh``."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_jax_env(tmp_path, **extra):
    """The environment with a `jax` package first on PYTHONPATH whose
    import raises, so any step that imports JAX fails the pipeline."""
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('the port pipeline imported jax')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path / "nojax"), ROOT] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(DEVICE="cpu", OMP_NUM_THREADS="2", **extra)
    return env


def _run(script, env):
    proc = subprocess.run(["bash", os.path.join(ROOT, script)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (
        f"pipeline failed:\nSTDOUT:\n{proc.stdout[-3000:]}\n"
        f"STDERR:\n{proc.stderr[-3000:]}")
    return proc.stdout


def test_fake_jax_refuses_to_import(tmp_path):
    env = _no_jax_env(tmp_path)
    proc = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "the port pipeline imported jax" in proc.stderr


def test_torch_dataset_pipeline_end_to_end_without_jax(tmp_path):
    from tools.make_toy_data import main as make_main

    make_main([str(tmp_path / "gen"), "--queries", "30", "--features",
               "136", "--libsvm"])
    raw = tmp_path / "raw"
    raw.mkdir()
    # A Fold-style directory: {train,vali,test}.txt.
    for src, dst in (("train", "train"), ("valid", "vali"),
                     ("test", "test")):
        shutil.copy(tmp_path / "gen" / src / f"{src}.txt",
                    raw / f"{dst}.txt")
    work = tmp_path / "work"
    out = _run("example/torch_dataset_pipeline.sh", _no_jax_env(
        tmp_path, DATA_PATH=str(raw), WORK=str(work), FEATURES="136",
        MAX_ITER="20", BATCH="8", SETTING="configs/naive.json"))
    assert "Training windows: eager" in out
    for f in ("rank/model.npz", "rank/train.predict", "rank/valid.predict",
              "rank/test.predict", "prep/settings.json",
              "prep/train/train.feature", "prep/train/train.labels",
              "prep/train/train.init_list",
              "prep/train/train.initial_scores", "prep/test/test.init_list"):
        assert (work / f).exists(), f
    # train.predict re-scores the full (not the sampled) train file.
    n_train = len((work / "normalized" / "train.txt").read_text()
                  .splitlines())
    assert len((work / "rank" / "train.predict").read_text()
               .splitlines()) == n_train
    lines = (work / "out" / "test.ranklist").read_text().splitlines()
    assert lines and all(len(line.split()) == 6 for line in lines)


def test_toy_pipeline_end_to_end_without_jax(tmp_path):
    work = tmp_path / "work"
    _run("example/toy/torch_offline_exp_pipeline.sh", _no_jax_env(
        tmp_path, WORK=str(work), MAX_ITER="10"))
    assert (work / "rank" / "model.npz").exists()
    assert (work / "prep" / "train" / "train.feature").exists()
    assert (work / "out" / "test.ranklist").read_text().strip()
