"""The reference's pretrain -> checkpoint -> serve flow
(examples/pretrain_and_serve.py) under both packages at tiny-llama, on the
CPU.

The same numpy token rows stream through each package's Dataset into its
trainer (JaxTrainer in the reference, TorchTrainer in the port) for 8
steps from the same weights (ray_tpu.models.init_params(cfg, PRNGKey(0)),
given to the port through params_from_numpy) under make_optimizer(1e-3,
warmup_steps=5, total_steps=8). Each step's loss matches within
tests/test_torch_train.py's LOSS_TOL. The port's loop reports checkpoints
written by save_pytree; the kept one loads bit-exact, and serve.run over
it returns the same greedy tokens as the reference's LLMServer given
params_to_numpy of the same weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data
import ray_tpu.models as jmodels
import ray_tpu.serve
import ray_tpu.train
import ray_tpu_torch
import ray_tpu_torch.data
import ray_tpu_torch.serve
import ray_tpu_torch.train
from ray_tpu_torch.models import get_config, params_from_numpy, params_to_numpy
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
LOSS_TOL = dict(rtol=1e-4, atol=0)  # tests/test_torch_train.py
MODEL, BATCH, SEQ, STEPS, CKPT_STEPS = "tiny-llama", 4, 32, 8, (3, 7)
ENGINE = dict(max_batch_size=4, max_seq_len=64, page_size=8, max_pages=64,
              prefill_buckets=(16, 32))
PROMPTS = [[5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
WAIT_S = 300


def token_rows():
    cfg = jmodels.get_config(MODEL)
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (BATCH * STEPS, SEQ + 1)).astype(np.int32)


def split(batch):
    toks = batch["tokens"]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def reference_flow(init):
    """JaxTrainer over ray_tpu.data -> the losses."""
    jcfg = jmodels.get_config(MODEL)

    def loop(config):
        from ray_tpu import train
        from ray_tpu.train import lm

        opt = lm.make_optimizer(learning_rate=1e-3, warmup_steps=5, total_steps=STEPS)
        params = jax.tree.map(jnp.asarray, init)
        state = {"step": jnp.zeros((), jnp.int32), "params": params,
                 "opt_state": opt.init(params)}
        step_fn = jax.jit(lm.make_train_step(jcfg, opt))
        for batch in train.get_dataset_shard("train").iter_batches(batch_size=BATCH):
            state, m = step_fn(state, jax.tree.map(jnp.asarray, split(batch)))
            train.report({"loss": float(m["loss"])})

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0, system_config=dict(THREAD_MODE))
    try:
        ds = ray_tpu.data.from_numpy({"tokens": token_rows()}, parallelism=4)
        result = ray_tpu.train.JaxTrainer(
            loop, scaling_config=ray_tpu.train.ScalingConfig(num_workers=1),
            run_config=ray_tpu.train.RunConfig(name="pretrain"), datasets={"train": ds}).fit()
    finally:
        ray_tpu.shutdown()
    assert result.error is None, result.error
    return [m["loss"] for m in result.metrics_history]


def port_flow(init, storage):
    """TorchTrainer over ray_tpu_torch.data -> (losses, result, the params
    at each checkpointed step)."""
    tcfg = get_config(MODEL)
    kept = {}

    def loop(config):
        from ray_tpu_torch import train

        opt = train.make_optimizer(learning_rate=1e-3, warmup_steps=5, total_steps=STEPS)
        state = train.init_train_state(tcfg, opt, device="cpu",
                                       params=params_from_numpy(init, device="cpu"))
        step_fn = train.make_train_step(tcfg, opt)
        batches = train.get_dataset_shard("train").iter_device_batches(
            batch_size=BATCH, device="cpu", transform=split)
        for step, batch in enumerate(batches):
            state, m = step_fn(state, batch)
            ckpt = None
            if step in CKPT_STEPS:
                path = os.path.join(config["storage"], f"step{step}")
                train.save_pytree({"params": state["params"], "step": step},
                                  os.path.join(path, "state"))
                kept[step] = {k: v.detach().clone() for k, v in flatten(state["params"]).items()}
                ckpt = train.Checkpoint(path)
                ckpt.set_metadata({"step": step})
            train.report({"loss": float(m["loss"]), "step": step}, checkpoint=ckpt)

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, system_config=dict(THREAD_MODE))
    try:
        ds = ray_tpu_torch.data.from_numpy({"tokens": token_rows()}, parallelism=4)
        result = ray_tpu_torch.train.TorchTrainer(
            loop, train_loop_config={"storage": storage},
            scaling_config=ray_tpu_torch.train.ScalingConfig(num_workers=1),
            run_config=ray_tpu_torch.train.RunConfig(
                name="pretrain", storage_path=storage,
                checkpoint_config=ray_tpu_torch.train.CheckpointConfig(num_to_keep=1)),
            datasets={"train": ds}).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    return [m["loss"] for m in result.metrics_history], result, kept


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def serve_tokens(name, params_fn, **kw):
    """serve.run(LLMServer.bind(params_fn=...)) in one package -> the greedy
    tokens of PROMPTS."""
    api, serve = {"ray_tpu": (ray_tpu, ray_tpu.serve),
                  "ray_tpu_torch": (ray_tpu_torch, ray_tpu_torch.serve)}[name]
    serve.shutdown()
    api.shutdown()
    api.init(num_cpus=8, system_config=dict(THREAD_MODE))
    try:
        handle = serve.run(serve.LLMServer.bind(params_fn=params_fn,
                                                engine_config=dict(ENGINE), **kw),
                           name="pretrained")
        outs = [handle.remote({"prompt_ids": p, "max_tokens": 12, "temperature": 0.0})
                .result(timeout=WAIT_S) for p in PROMPTS]
        return [o["token_ids"] for o in outs]
    finally:
        try:
            serve.shutdown()
        finally:
            api.shutdown()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    jcfg = jmodels.get_config(MODEL)
    init = jax.tree.map(np.asarray, jmodels.init_params(jcfg, jax.random.PRNGKey(0)))
    storage = str(tmp_path_factory.mktemp("pretrain"))
    want = reference_flow(init)
    losses, result, kept = port_flow(init, storage)
    path = os.path.join(result.checkpoint.path, "state")
    loaded = ray_tpu_torch.train.load_pytree(path, device="cpu")
    tcfg = get_config(MODEL)
    port_tokens = serve_tokens("ray_tpu_torch", lambda: (
        ray_tpu_torch.train.load_pytree(path, device="cpu")["params"], tcfg), device="cpu")
    trained = params_to_numpy(loaded["params"])
    ref_tokens = serve_tokens("ray_tpu", lambda: (trained, jcfg))
    return dict(want=want, losses=losses, result=result, kept=kept, loaded=loaded,
                port_tokens=port_tokens, ref_tokens=ref_tokens, storage=storage)


def test_losses_match_reference(pipeline):
    got, want = pipeline["losses"], pipeline["want"]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert len(set(got)) == STEPS  # eight steps on eight batches


def test_checkpoint_loads_bit_exact(pipeline):
    result, loaded = pipeline["result"], pipeline["loaded"]
    assert result.checkpoint.get_metadata() == {"step": CKPT_STEPS[-1]}
    assert loaded["step"] == CKPT_STEPS[-1]
    want = pipeline["kept"][CKPT_STEPS[-1]]
    got = flatten(loaded["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # num_to_keep=1: the step-3 checkpoint's directory went
    assert sorted(n for n in os.listdir(pipeline["storage"]) if n.startswith("step")) == ["step7"]


def test_served_greedy_tokens_match_reference(pipeline):
    got, want = pipeline["port_tokens"], pipeline["ref_tokens"]
    assert got == want
    assert [len(t) for t in got] == [12, 12]


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg = jmodels.get_config(MODEL)
    tree = jax.tree.map(np.asarray, jmodels.init_params(jcfg, jax.random.PRNGKey(1)))
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat_a, flat_b = flatten(tree), flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        assert flat_b[k].dtype == flat_a[k].dtype and np.array_equal(flat_a[k], flat_b[k]), k
    bf16 = params_to_numpy(params_from_numpy(tree, device="cpu", dtype="bfloat16"))
    w = flatten(bf16)["layers/wq"]
    assert w.dtype == np.float32
    np.testing.assert_array_equal(
        w, torch.tensor(flat_a["layers/wq"]).to(torch.bfloat16).float().numpy())
