"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's tests: two encoder layers of 64, a ResNet-50 over 64 x 128
canvases, a few boxes, the loader in threads, float32. Widths are cut
here only: the benchmark's cells run the published ones.

Such a cell has limits of its own: the port's float32 CPU path against
the float32 reference is the same arithmetic in another order, whose
gaps read up to ~1e-4 (the image path's worst leaf); the faults and the
float8 control read 1e-2 or more."""

import copy

from portbench import check, harness

TINY_LIMIT = 1e-3


def tiny_cell(name, dtype="float32", bench=None, bench_dir=harness.BENCH_DIR,
              limits=TINY_LIMIT):
    """The cell ``name`` at the tests' size; its limits all ``limits``, or
    the cell's own file's where ``limits`` is None."""
    c = copy.deepcopy(harness.cell(name, bench, bench_dir))
    cfg = c["config_spec"]["config"]
    cfg["NETWORK"]["VLBERT"].update(
        hidden_size=64, visual_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, vocab_size=2000)
    cfg["NETWORK"]["IMAGE_FINAL_DIM"] = 64
    cfg["NUM_WORKERS_PER_GPU"] = 0
    cfg["TPU"]["COMPUTE_DTYPE"] = dtype
    d = c["traffic_spec"]["data"]
    d.update(images=4, questions=64, vocab_size=2000)
    c["traffic_spec"]["warmup_steps"] = 0
    if limits is not None:
        c["limits"] = {k: limits for k in ["loss_gap"] + [
            f"{n}.{g}" for n in ("grad_gap", "change_gap")
            for g in check.GROUPS]}
    cfg["NETWORK"]["IMAGE_NUM_LAYERS"] = 50
    cfg["SCALES"] = [64, 128]
    cfg["TRAIN"]["BATCH_IMAGES"] = 2
    d.update(boxes=[1, 3])
    d["texture"] = dict(d["texture"], bank=1)
    return c


def run(cell, fault=None, control=False, seed=123456789012, seconds=0.0,
        trace=False):
    import time

    driver = harness.load(cell["traffic_spec"]["driver"], cell["bench_dir"])
    return driver.run(cell, seed, seconds, trace,
                      t_start=time.perf_counter(), device="cpu",
                      fault=fault, control=control,
                      window=seconds > 0 and fault is None and not control)
