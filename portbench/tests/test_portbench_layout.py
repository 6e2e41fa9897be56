"""BENCHMARK.json keeps to the contract's characters and keys, every cell
finds its files by name, a cell or a metric is added by adding files, and
nothing the harness or a reference loads is JAX or the JAX package."""
import ast
import json
import re
import shutil
import subprocess
import sys


from portbench import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "metric": {"name", "unit", "better", "bound", "source"},
        "layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _bench():
    return json.loads((R.ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == KEYS["config"]
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["metric"]
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e


def test_every_cell_resolves_its_files():
    b = _bench()
    for w in b["workloads"]:
        bench, work, conf, spec = R.cell(R.ROOT, w["name"])
        assert conf["name"] == w["config"]
        assert (R.ROOT / "portbench" / "drivers"
                / f"{conf['driver']}.py").exists()
        assert (R.ROOT / "portbench" / "reference"
                / f"{conf['reference']}.py").exists()
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric, each read by a reader of its own
        e2e = [m for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and layer
        for m in layer:
            assert callable(R.reader(R.ROOT, m["name"]))
            moved = next(x for x in b["end_to_end"]
                         if x["name"] == m["moves"])
            assert w["name"] in moved.get("workloads", [w["name"]])


def test_a_cell_and_a_metric_are_added_by_files(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a per-layer
    metric by new files and new entries only; the harness finds them."""
    root = tmp_path / "checkout"
    shutil.copytree(R.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    b = _bench()
    spec = json.loads((root / "portbench" / "traffic"
                       / "serve-decode-heavy.json").read_text())
    spec.update(rate_rps=10.0, arrival="gamma", cv=3.0)
    (root / "portbench" / "traffic" / "serve-bursty.json").write_text(
        json.dumps(spec))
    (root / "portbench" / "metrics" / "lag_ms.serve.py").write_text(
        "def read(data, job):\n    return max(data['lag']) * 1e3\n")
    b["workloads"].append({"name": "serve-bursty",
                           "config": "surrogate-qwen2-0.5b-tp2",
                           "traffic": "serve-bursty", "chips": 1,
                           "why": "bursts"})
    b["per_layer"].append({"name": "lag_ms.serve", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "API server and tokenizer pool",
                           "moves": "tpot_p50_ms",
                           "workloads": ["serve-bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    bench, work, conf, spec2 = R.cell(root, "serve-bursty")
    assert spec2["arrival"] == "gamma"
    assert R.reader(root, "lag_ms.serve")({"lag": [0.001, 0.002]},
                                           None) == 2.0
    for p, raw in before.items():
        assert p.read_bytes() == raw


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in (R.ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in (R.ROOT / "portbench" / "reference").glob("*.py"):
        mods = set(_imports(path))
        assert not mods & (FORBIDDEN | {"repro_torch"}), path
        assert mods <= {"__future__", "functools", "heapq", "re", "typing",
                        "math", "numpy", "torch", "portbench"}, (path, mods)


def test_a_run_loads_no_jax():
    """A whole run at a toy size on the CPU, in a fresh process: nothing
    it loads has the top-level name jax, jaxlib, flax or repro."""
    code = r"""
import copy, sys, tempfile
sys.path[:0] = [{root!r}, {src!r}]
from portbench import run as R
bench, work, conf, spec = R.cell(R.ROOT, "gen-decode")
conf = copy.deepcopy(conf)
conf["model"].update(hidden_size=32, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=1, num_local_experts=4,
    num_experts_per_tok=2, intermediate_size=16, vocab_size=64)
spec = dict(spec, rows=2, prompt_tokens=8, new_tokens=3, warmup_batches=1,
            check_batches=1)
job = R.Job(work, conf, spec, 5, 0.05, False, tempfile.mkdtemp(),
            device="cpu", pin=False)
res = R.measure(bench, job)
import portbench.reference.surrogate, portbench.reference.granite_moe
import portbench.drivers.serve, portbench.sweep, portbench.readings
print(sorted({{m.split('.')[0] for m in sys.modules}} & {bad!r}))
""".format(root=str(R.ROOT), src=str(R.ROOT / "src"),
           bad=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_or_with_missing_files(tmp_path):
    out = subprocess.run([sys.executable, str(R.ROOT / "portbench" / "run.py"),
                          "--workload", "gen-decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    # only BENCHMARK.json and the benchmark's files: no program to run
    shutil.copytree(R.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, str(tmp_path / "portbench" /
                                              "run.py"),
                          "--workload", "gen-decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
