"""Declarative per-architecture serving capabilities: the port's copy of
``repro.core.capabilities`` (``ArchCapabilities.from_config``,
``supports``, ``require``, ``render_text``), with the same derivation
rules, the same wording of the error and the same matrix.

One record per architecture, derived from its ``ModelConfig`` when the
engine is built (``Engine.caps``).  The schedulers consult it through
``require(path)``: an ineligible (arch, path) pair raises one uniformly
worded error naming the blocking capability and the fallback.

* ``chunked`` / ``spec`` need a resumable token-position cache: recurrent
  mixers (``ssd``/``rglru``) carry state across a chunk boundary that the
  fused step does not checkpoint, so they fall back to whole-prompt
  admission (as do frontends and multi-codebook heads).
* ``paged`` needs every attention cache to be block-addressable: a
  sliding-window ring index is not a block offset.
* ``disagg`` = ``chunked`` AND ``paged``; ``overlap`` is never blocked.
* ``max_prompt``: a ring keeps only the last ``window`` tokens, so
  in-flight admission caps prompts at the window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig

PATHS: Tuple[str, ...] = ("chunked", "spec", "paged", "disagg", "overlap")

PATH_NAMES: Dict[str, str] = {
    "chunked": "chunked prefill",
    "spec": "speculative decoding",
    "paged": "paged KV",
    "disagg": "disaggregated prefill/decode",
    "overlap": "overlapped decode",
}

# What an ineligible arch gets instead of the path.
FALLBACKS: Dict[str, str] = {
    "chunked": "whole-prompt admission",
    "spec": "plain one-token decode",
    "paged": "the dense slot engine",
    "disagg": "the unified paged engine",
    "overlap": "the blocking engine loop",
}

# Blocking-capability tags -> the phrases of the ``require()`` error.
BLOCKERS: Dict[str, str] = {
    "ring": "the sliding-window ring cache layout",
    "recurrent": "the recurrent-state cache layout (no chunk-boundary carry)",
    "frontend": "the modality-prefix frontend",
    "codebooks": "per-codebook sampling (multi-codebook head)",
}


@dataclass(frozen=True)
class ArchCapabilities:
    """Declarative serving-capability record for one architecture."""

    arch: str
    cache_layouts: Tuple[str, ...]   # e.g. ("dense", "ring", "recurrent-state")
    sampling: str                    # "single" | "per-codebook"
    max_prompt: Optional[int]        # in-flight admission clamp; None = max_len only
    blockers: Dict[str, str]         # path id -> blocking tag (absent = supported)

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "ArchCapabilities":
        kinds = set(cfg.layer_pattern)
        ring = cfg.window > 0 and "local_attn" in kinds
        recurrent = bool(kinds & {"ssd", "rglru"})
        multi_cb = cfg.n_codebooks > 1
        has_frontend = cfg.frontend is not None

        def first_blocker(*conds) -> Optional[str]:
            return next((tag for tag, hit in conds if hit), None)

        chunk_block = first_blocker(("frontend", has_frontend), ("codebooks", multi_cb),
                                    ("recurrent", recurrent))
        paged_block = first_blocker(("ring", ring), ("frontend", has_frontend),
                                    ("codebooks", multi_cb))
        blockers: Dict[str, str] = {}
        if chunk_block:
            blockers["chunked"] = chunk_block
            blockers["spec"] = chunk_block
        if paged_block:
            blockers["paged"] = paged_block
        if chunk_block or paged_block:
            blockers["disagg"] = chunk_block or paged_block

        layouts = ["dense"]
        if cfg.mla is not None:
            layouts.append("latent")
        if ring:
            layouts.append("ring")
        if recurrent:
            layouts.append("recurrent-state")
        if "paged" not in blockers:
            layouts.append("paged")
        return cls(arch=cfg.name, cache_layouts=tuple(layouts),
                   sampling="per-codebook" if multi_cb else "single",
                   max_prompt=cfg.window if ring else None, blockers=blockers)

    def supports(self, path: str) -> bool:
        return self.blocker(path) is None

    def blocker(self, path: str) -> Optional[str]:
        """Blocking-capability tag for ``path`` (None if supported)."""
        if path not in PATHS:
            raise KeyError(f"unknown serving path {path!r}; known: {PATHS}")
        return self.blockers.get(path)

    def require(self, path: str) -> None:
        """Raise the uniformly worded capability error if ``path`` is not
        supported by this arch."""
        tag = self.blocker(path)
        if tag is None:
            return
        raise ValueError(
            f"arch {self.arch!r} does not support {PATH_NAMES[path]}: "
            f"blocked by {BLOCKERS[tag]} — use {FALLBACKS[path]} instead"
        )


def registry() -> Dict[str, ArchCapabilities]:
    """arch-id -> capability record, for every registered architecture."""
    from repro_torch import configs      # configs never imports core

    return {arch: ArchCapabilities.from_config(configs.get_config(arch))
            for arch in configs.ALL_ARCHS}


def _cell(caps: ArchCapabilities, path: str) -> str:
    tag = caps.blocker(path)
    return "✓" if tag is None else f"✗ {tag}"


def render_text() -> str:
    """Plain-text capability matrix (``serve.py --list-archs``), arch by
    arch in sorted order, then the blocking capabilities' legend."""
    header = ["arch", *PATHS, "sampling", "max-prompt"]
    rows: List[List[str]] = [header]
    for arch, caps in sorted(registry().items()):
        rows.append([arch, *(_cell(caps, p) for p in PATHS), caps.sampling,
                     str(caps.max_prompt) if caps.max_prompt else "-"])
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    legend = ["", "blocking capabilities:"]
    legend += [f"  {tag:<10} {phrase}" for tag, phrase in sorted(BLOCKERS.items())]
    return "\n".join(lines + legend)


def as_dict() -> Dict[str, dict]:
    """The capability matrix as JSON (the frontend's ``GET /health``)."""
    return {arch: {"paths": {p: {"supported": caps.supports(p), "blocker": caps.blocker(p)}
                             for p in PATHS},
                   "cache_layouts": list(caps.cache_layouts), "sampling": caps.sampling,
                   "max_prompt": caps.max_prompt}
            for arch, caps in sorted(registry().items())}
