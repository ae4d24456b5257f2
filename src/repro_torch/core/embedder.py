"""Embedding front-end for Seri stage 1.

Two implementations behind one interface:

* ``ModelEmbedder`` — a real (small, e.g. qwen3-0.6b-class) encoder on the
  port's model stack: byte-level tokens → transformer (its attention the
  ``flash_attention_fwd`` kernel) → masked mean-pool → L2-normalise. With
  random init it still yields a deterministic, locality-free fingerprint;
  it exists to measure the true compute cost of the embedding stage and to
  exercise the co-location path. (No pretrained weights exist offline.)
* ``WorldEmbedder`` — the synthetic-semantic-world embedder used for the
  paper's behavioural experiments: paraphrases of one intent share a
  cluster center, hard negatives sit at a controlled cosine distance —
  giving ANN realistic true/false-positive structure (DESIGN.md §6).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def l2_normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, 1e-9)


def byte_tokens(text: str, max_len: int) -> np.ndarray:
    raw = np.frombuffer(text.encode("utf-8")[:max_len], dtype=np.uint8)
    out = np.zeros(max_len, np.int32)
    out[: len(raw)] = raw.astype(np.int32) + 3  # 0 = pad
    return out


class ModelEmbedder:
    """``params`` (the port's LM parameters, e.g. from
    ``convert.lm_params_from_numpy``) replaces the seeded init.

    :meth:`encode` is the function the reference jits. On a CUDA device
    ``embed_batch`` runs it as a CUDA graph per batch size B at
    ``max_len`` (``kernels/graphs.StepGraph``, one pool), captured at the
    first batch of that size, the padding mask and the pooling inside it:
    the tokens go into the graph's static buffer from pinned memory, and
    the (B, d_model) rows come down. On the CPU it calls :meth:`encode`
    eagerly."""

    def __init__(self, cfg=None, dim: int = 256, max_len: int = 64, seed=0,
                 device="cuda", params=None):
        from repro_torch.configs import get_config, shrink
        from repro_torch.models.lm import LM
        from repro_torch.nn.param import init_params

        cfg = cfg or shrink(get_config("qwen3-0.6b"), d_model=dim, vocab=512,
                            n_repeat=2)
        self.cfg = cfg
        self.max_len = max_len
        self.device = resolve_device(device)
        self.lm = LM(cfg)
        self.params = params if params is not None else init_params(
            self.lm.param_specs(),
            torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        self._graphs: dict = {}        # B -> (graph, tokens)
        self._pool = None

    @property
    def dim(self) -> int:
        return self.cfg.d_model

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens (0 = pad) -> (B, d_model) unit fp32 rows."""
        x = self.lm._embed(self.params, tokens)
        x, _, _ = self.lm._run_stack(self.params, x,
                                     self.lm._positions(tokens))
        mask = (tokens > 0).float()[..., None]
        pooled = torch.sum(x.float() * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1.0)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-6)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        toks = np.stack(
            [byte_tokens(t % self.cfg.vocab_size if isinstance(t, int)
                         else t, self.max_len) for t in texts]
        ) % self.cfg.vocab_size
        host = torch.from_numpy(toks)
        if self.device.type != "cuda":
            with torch.inference_mode():
                out = self.encode(host.to(self.device))
            return out.cpu().numpy().astype(np.float32)
        graph, buf = self._graph_for(host.shape[0])
        buf.copy_(host.pin_memory(), non_blocking=True)
        return graph.replay().cpu().numpy().astype(np.float32)

    def _graph_for(self, b: int) -> tuple:
        """The graph of :meth:`encode` on a static (b, max_len) token
        buffer, captured the first time it is asked for."""
        if b not in self._graphs:
            from repro_torch.kernels.graphs import StepGraph

            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            buf = torch.zeros((b, self.max_len), dtype=torch.int32,
                              device=self.device)

            def step():
                with torch.inference_mode():
                    return self.encode(buf)

            self._graphs[b] = (StepGraph(step, self._pool), buf)
        return self._graphs[b]

    @property
    def graph_pool_bytes(self) -> int:
        """What the captures added to the embedder's graph pool."""
        return sum(g.pool_bytes for g, _ in self._graphs.values())


class WorldEmbedder:
    """Looks up embeddings from a synthetic semantic world (data.world)."""

    def __init__(self, world):
        self.world = world

    @property
    def dim(self) -> int:
        return self.world.dim

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.world.embed(t) for t in texts])
