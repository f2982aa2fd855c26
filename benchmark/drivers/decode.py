"""The serving driver: back-to-back greedy ``workload.generate`` calls on
``quantize_model`` of a TinyLM holding the benchmark's weights, closed
loop.

Every call decodes ``batch`` rows into a cache of ``total_len`` positions
from the traffic's prompts; a row of prompt length p serves
``total_len - p`` tokens.  After the window a sample of the rows served,
drawn from the seed and holding the row that served most, is judged by
the reference: the int8 weights derived again from the float ones, in
fp32."""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import inputs
from ..measure import trace
from . import Phases
from ..reference import gpt2


def model_config(config: Dict, device: torch.device):
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return wl.ModelConfig(**config["model"], dtype=dtype)


class Run:
    """One run of a serving cell."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, tracing: bool,
                 fault: Optional[str] = None) -> None:
        from k8s_operator_libs_tpu_torch.tpu import workload as wl

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = config["model"]
        self.cfg = model_config(config, self.device)
        self.fault = fault
        self.phases = Phases()
        float_model = wl.TinyLM(self.cfg, device=self.device, seed=seed % inputs.SEED_MOD)
        self.phases.lap("float_model")
        with torch.no_grad():
            float_model.load_state_dict(inputs.make_weights(self.model, seed, self.device))
        self.phases.lap("weights")
        self.served = wl.quantize_model(float_model)
        del float_model
        self.phases.lap("quantize_model")
        self.outputs: list = []
        self.calls = 0
        # the cell's kernels at its batch, and a cache of its span held
        # once by the allocator
        b = traffic["batch"]
        wl.generate(self.cfg, self.served, torch.zeros(b, 4, dtype=torch.long), 4, device=self.device)
        wl.KVCache(self.cfg, b, traffic["total_len"], self.device)
        self._sync()
        self.phases.lap("warm_up")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self, keep: bool = True):
        """One generate call on the next prompts; returns its buffer."""
        from k8s_operator_libs_tpu_torch.tpu import workload as wl

        t = self.traffic
        prompt, lens = inputs.decode_prompts(t["prompt_len"], self.model["vocab_size"], t["batch"],
                                             self.seed, self.calls)
        self.calls += 1
        buf = wl.generate(self.cfg, self.served, prompt, t["total_len"] - prompt.shape[1],
                          prompt_lens=lens, device=self.device)
        if self.fault is not None:
            buf = plant_fault(buf, lens, self.fault, self.model["vocab_size"])
        if keep:
            self.outputs.append((prompt, lens, buf))
        return buf

    def window(self, seconds: float) -> Dict:
        """Calls back to back until *seconds* have passed; the last call
        that started inside the window ends it, and no call is cut."""
        from k8s_operator_libs_tpu_torch.tpu import quantize

        quantize.reset_launch_counts()
        t0 = time.perf_counter()
        call_s = []
        while True:
            t = time.perf_counter()
            self.call()
            self._sync()
            end = time.perf_counter()
            call_s.append(end - t)
            if end - t0 >= seconds:
                break
        total = self.traffic["total_len"]
        served = sum(int((total - lens).sum()) for _, lens, _ in self.outputs)
        return {"elapsed_s": end - t0, "call_s": call_s, "calls": len(call_s), "tokens": served,
                "attempted": len(call_s) * self.traffic["batch"], "failed": 0,
                "launches": dict(quantize.device_launch_counts)}

    def traced(self) -> Dict:
        """One more call, the profiler on over the traffic's
        ``trace_steps`` decode steps from ``trace_first_step``, with the
        port's launch counters read over them."""
        from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
        from k8s_operator_libs_tpu_torch.tpu import quantize

        first, n = self.traffic["trace_first_step"], self.traffic["trace_steps"]
        prof = trace.profiler()
        step = {"i": 0, "on": False, "launches": {}}

        def stop():
            self._sync()
            prof.stop()
            step["on"] = False
            step["launches"] = {**quantize.device_launch_counts, **fa.device_launch_counts}

        def hook(module, args, kwargs):
            if step["i"] == first:
                fa.reset_launch_counts()
                quantize.reset_launch_counts()
                prof.start()
                step["on"] = True
            elif step["i"] == first + n:
                stop()
            step["i"] += 1

        handle = self.served.register_forward_pre_hook(hook, with_kwargs=True)
        try:
            self.call(keep=False)
        finally:
            handle.remove()
            if step["on"]:
                stop()
        if step["i"] < first + n:
            raise ValueError(f"a call of {step['i']} steps cannot trace steps {first}-{first + n}")
        summary = trace.summarize(prof)
        if summary is not None:
            summary["steps"] = n
            summary["launches"] = step["launches"]
        return summary

    def free(self) -> None:
        del self.served
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(rows [r, T], prompt lengths [r], prompts [r, P]) of the rows
        judged: ``check_rows`` drawn from the seed over every row served,
        the row that served most among them."""
        rows = [(c, r) for c in range(len(self.outputs)) for r in range(self.traffic["batch"])]
        lens = {(c, r): int(self.outputs[c][1][r]) for c, r in rows}
        longest = min(rows, key=lambda cr: (lens[cr], cr))
        rng = np.random.default_rng([self.seed % inputs.SEED_MOD, 1])
        others = [rows[i] for i in rng.permutation(len(rows)) if rows[i] != longest]
        picked = [longest] + others[: self.traffic["check_rows"] - 1]
        out = torch.stack([self.outputs[c][2][r].cpu() for c, r in picked])
        plens = torch.tensor([lens[cr] for cr in picked])
        prompts = torch.stack([self.outputs[c][0][r] for c, r in picked])
        return out, plens, prompts

    def check(self, control: bool = False) -> Dict:
        """The numbers of the sample: ``gap_max``, the widest gap by which a
        served token's logit lies below the reference's best (with
        *control*, that of the token int4 weights put first), and
        ``prompt_mismatch``, prompt tokens the program changed, and
        ``out_of_vocab``, tokens outside the vocabulary."""
        rows, plens, prompts = self.sample()
        v = self.model["vocab_size"]
        mismatch = sum(int((row[:p] != prompt[:p]).sum()) for row, p, prompt in zip(rows, plens.tolist(), prompts))
        out_of_vocab = int(((rows < 0) | (rows >= v)).sum())
        rows = rows.clamp(0, v - 1).to(self.device)
        w = inputs.make_weights(self.model, self.seed, self.device)
        h, n_layers = self.model["n_heads"], self.model["n_layers"]
        with gpt2.fp32_matmuls():
            ref = gpt2.quantized(w, h, 8)
            pick = gpt2.quantized(w, h, 4) if control else None
            del w
            gaps = gpt2.served_gaps(ref, rows, plens, h, n_layers, pick=pick)
        return {
            "gap_max": {"value": float(gaps.max())},
            "prompt_mismatch": {"value": mismatch},
            "out_of_vocab": {"value": out_of_vocab},
        }


def plant_fault(buf: torch.Tensor, lens: torch.Tensor, fault: str, vocab: int) -> torch.Tensor:
    """Break what the timed path returns, for the checks that must come
    out false: ``token`` (every served token altered where it is
    produced) or ``half_batch`` (half of the rows left undecoded)."""
    served = torch.arange(buf.shape[1], device=buf.device)[None, :] >= lens.to(buf.device)[:, None]
    if fault == "token":
        return torch.where(served, (buf + 1) % vocab, buf)
    if fault == "half_batch":
        half = torch.arange(buf.shape[0], device=buf.device)[:, None] >= buf.shape[0] // 2
        return torch.where(served & half, torch.zeros_like(buf), buf)
    raise ValueError(f"no fault {fault!r} for serving")
