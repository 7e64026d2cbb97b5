"""The port's input specs (`repro_torch.launch.input_specs`: meta tensors)
against the JAX package's ``ShapeDtypeStruct``s: every architecture of the
registry at full width, every assigned shape, 1 / 4 / 16 workers.  Exact:
shapes and dtypes are equal, leaf for leaf."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.launch import input_specs as jspecs
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.launch import input_specs as tspecs


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def test_shapes_table_matches():
    assert tspecs.LONG_CONTEXT_WINDOW == jspecs.LONG_CONTEXT_WINDOW
    assert list(tspecs.SHAPES) == list(jspecs.SHAPES)
    for name, s in jspecs.SHAPES.items():
        t = tspecs.SHAPES[name]
        assert (t.name, t.kind, t.seq_len, t.global_batch) == \
            (s.name, s.kind, s.seq_len, s.global_batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    for shape in jspecs.SHAPES:
        for w in (1, 4, 16):
            want = _flat(jspecs.input_specs(jcfg, jspecs.SHAPES[shape],
                                            num_workers=w))
            got = _flat(tspecs.input_specs(tcfg, tspecs.SHAPES[shape],
                                           num_workers=w))
            assert sorted(got) == sorted(want), (shape, w)
            for k, x in got.items():
                assert x.device.type == "meta"
                assert tuple(x.shape) == tuple(want[k].shape), (shape, w, k)
                assert _dtype(x) == _dtype(want[k]), (shape, w, k)
        assert tspecs.adapt_config(tcfg, tspecs.SHAPES[shape]) \
            .sliding_window == jspecs.adapt_config(
                jcfg, jspecs.SHAPES[shape]).sliding_window


def test_train_specs_worker_split():
    cfg = torch_config("qwen3-1.7b")
    s = tspecs.SHAPES["train_4k"]
    specs = tspecs.train_input_specs(cfg, s, 16)
    assert specs["tokens"].shape == (16, 16, 4096)
    assert specs["labels"].shape == (16, 16, 4096)
    with pytest.raises(ValueError, match="not divisible by 7"):
        tspecs.train_input_specs(cfg, s, 7)      # 256 not divisible by 7


def test_adapt_config_long_context_window():
    cfg = torch_config("stablelm-3b")
    assert tspecs.adapt_config(cfg, tspecs.SHAPES["long_500k"]) \
        .sliding_window == 4096
    x = torch_config("xlstm-125m")                 # no attention: unchanged
    assert tspecs.adapt_config(x, tspecs.SHAPES["long_500k"]) \
        .sliding_window == 0
    assert tspecs.adapt_config(cfg, tspecs.SHAPES["decode_32k"]) \
        .sliding_window == 0


def test_vlm_specs_patches_plus_text():
    cfg = torch_config("qwen2-vl-72b")
    s = tspecs.SHAPES["train_4k"]
    specs = tspecs.train_input_specs(cfg, s, 16)
    p = specs["patch_embeds"].shape[2]
    assert p == cfg.num_patches
    assert specs["tokens"].shape[2] + p == s.seq_len
    assert specs["positions"].shape[1] == 3     # m-rope streams
    assert specs["positions"].shape == (16, 3, 16, s.seq_len)
    assert specs["positions"].dtype == torch.int32
    assert specs["patch_embeds"].dtype == torch.bfloat16


def test_decode_specs_one_token():
    for arch, key in (("qwen3-1.7b", "tokens"),
                      ("musicgen-large", "frame_embeds")):
        d = tspecs.input_specs(torch_config(arch), tspecs.SHAPES["decode_32k"])
        assert list(d["batch"]) == [key]
        assert d["batch"][key].shape[:2] == (128, 1)
        assert d["cur"].shape == () and d["cur"].dtype == torch.int32
