"""Predictor (counterpart of ``paddle_tpu/inference/predictor.py``;
reference capability: paddle's analysis predictor and the paddle_infer
handle API: get_input_names / get_input_handle / run /
get_output_handle).

The predictor wraps a layer (an ``nn.Module``) that lives on its device
(default "cuda"); ``run`` calls it under ``torch.no_grad`` and returns
numpy outputs (bf16 outputs as float32, exactly). ``generate``,
``generate_speculative`` and ``serve`` go to the model's generation loop
and to the continuous-batching engine. A serialized artifact (a Config
naming a model directory) and the AOT export wait for serialization and
``jit/`` (ROADMAP.md §1 item 8).
"""
import numpy as np
import torch

from ..device import resolve
from ..generation import prompt_bucket

_AOT = ("AOT export and load come with serialization and jit/ "
        "(ROADMAP.md §1 item 8)")


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class _IOHandle:
    """Zero-copy style tensor handle (reference: ZeroCopyTensor)."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def reshape(self, shape):
        self._shape = tuple(shape)

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def share_external_data(self, arr):
        self._value = arr

    def copy_to_cpu(self):
        return _to_numpy(self._value)

    def shape(self):
        return list(np.shape(_to_numpy(self._value)))


class Predictor:
    """``Predictor(layer, input_names=None, device="cuda")``: the layer
    must live on ``device`` (ValueError otherwise, as the engine's check);
    a Config from serialized artifacts raises the reference's
    ValueError."""

    def __init__(self, config_or_layer, input_names=None, device="cuda"):
        if not isinstance(config_or_layer, torch.nn.Module):
            raise ValueError(
                "create_predictor(Config) from serialized artifacts requires "
                "the model class; pass the Layer directly: "
                "create_predictor(layer) or Predictor(layer). For jit.save'd "
                "weights, build the Layer, layer.set_state_dict(paddle.jit."
                "load(path)['state_dict']), then Predictor(layer)."
            )
        dev = resolve(device)
        param = next(config_or_layer.parameters(), None)
        if param is not None and (param.device.type != dev.type or (
                dev.index is not None and param.device.index != dev.index)):
            raise ValueError(f"layer lives on {param.device}, the predictor "
                             f"on {dev}: move the layer first")
        self._layer = config_or_layer
        self._layer.eval()
        self.device = dev if param is None else param.device
        self._input_names = list(input_names) if input_names else ["x"]
        self._inputs = {n: _IOHandle(n) for n in self._input_names}
        self._outputs = {}

    # -- handle API --------------------------------------------------------
    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        return self._outputs[name]

    # -- execution ---------------------------------------------------------
    @torch.no_grad()
    def run(self, inputs=None):
        """Positional (a list of numpy arrays) or through the filled input
        handles; returns the outputs as numpy arrays in the first case,
        None in the second (read them from the output handles)."""
        if inputs is not None:
            arrs = [np.asarray(a) for a in inputs]
        else:
            arrs = [self._inputs[n]._value for n in self._input_names]
        out = self._layer(*[torch.as_tensor(np.asarray(a)).to(self.device)
                            for a in arrs])
        outs = out if isinstance(out, (tuple, list)) else [out]
        self._outputs = {}
        results = []
        for i, o in enumerate(outs):
            h = _IOHandle(f"out_{i}")
            h._value = o
            self._outputs[h.name] = h
            results.append(_to_numpy(o))
        return results if inputs is not None else None

    # -- generation --------------------------------------------------------
    def generate(self, input_ids, **kwargs):
        """The model's ``generate`` (GenerationMixin), as numpy."""
        if not hasattr(self._layer, "generate"):
            raise TypeError(f"{type(self._layer).__name__} has no generate()")
        return _to_numpy(self._layer.generate(np.asarray(input_ids),
                                              **kwargs))

    def generate_speculative(self, input_ids, draft_model, **kwargs):
        """Draft-verify decoding (exactly the target's greedy stream);
        ``draft_model`` is a layer or a Predictor."""
        draft = (draft_model._layer if isinstance(draft_model, Predictor)
                 else draft_model)
        return _to_numpy(self._layer.generate_speculative(
            np.asarray(input_ids), draft, **kwargs))

    def serve(self, prompts, max_new_tokens=32, eos_token_id=None,
              max_seqs=4, page_size=64, num_pages=None, max_len=None,
              engine=None, **serve_kwargs):
        """Continuous-batching serving over the paged KV pool
        (``inference.continuous.ContinuousBatchingEngine`` on the
        predictor's device). Without ``max_len`` it covers the longest
        prompt's bucket and its full decode, rounded to whole pages.
        ``engine`` reuses a warm engine; the other keywords (sampling,
        ``on_token``, overrides, adapters) pass through."""
        from .continuous import ContinuousBatchingEngine

        if engine is None:
            if max_len is None:
                longest = max(len(np.asarray(p).reshape(-1)) for p in prompts)
                max_len = max(prompt_bucket(longest), longest + max_new_tokens)
                max_len = -(-max_len // page_size) * page_size
            engine = ContinuousBatchingEngine(
                self._layer, max_seqs=max_seqs, page_size=page_size,
                num_pages=num_pages, max_len=max_len, device=str(self.device))
        return engine.serve(prompts, max_new_tokens, eos_token_id=eos_token_id,
                            **serve_kwargs)

    # -- AOT export --------------------------------------------------------
    def export_aot(self, path, *example_inputs):
        raise NotImplementedError(_AOT)

    @staticmethod
    def load_aot(path):
        raise NotImplementedError(_AOT)

    def clone(self):
        return Predictor(self._layer, self._input_names,
                         device=str(self.device))


class AotPredictor:
    """Runs a deserialized AOT export: not ported yet."""

    def __init__(self, exported):
        raise NotImplementedError(_AOT)

    def run(self, state, *inputs):
        raise NotImplementedError(_AOT)


def create_predictor(config_or_layer, input_names=None, device="cuda"):
    return Predictor(config_or_layer, input_names, device=device)
