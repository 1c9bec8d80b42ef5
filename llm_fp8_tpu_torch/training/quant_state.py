"""Per-layer delayed-scaling state for FP8 training (counterpart of
``llm_fp8_tpu/training/quant_state.py``): one :class:`ScaleState` per (GEMM
site, tensor class), stacked over layers, updated once per step from the
amaxes the forward reports and the sink gradients of the backward."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.llama import DOT_SITES, SITE_ROLE
from ..quant import RecipeSet
from ..quant.delayed import ScaleState, init_scale_state, observe_amax
from ..quant.dot import DotAmaxes

__all__ = ["init_train_quant_state", "forward_scales", "make_sinks", "update_quant_state"]


def init_train_quant_state(cfg: ModelConfig, recipes: RecipeSet, device="cpu"
                           ) -> Dict[str, Dict[str, ScaleState]]:
    """``{site: {"x"/"w"/"g": ScaleState stacked [L]}}`` for every site whose
    recipe scales per tensor (block and per-channel scales are just in time)."""
    state: Dict[str, Dict[str, ScaleState]] = {}
    for site in DOT_SITES:
        recipe = recipes.for_role(SITE_ROLE[site])
        if recipe is None or recipe.granularity != "tensor":
            continue
        state[site] = {t: init_scale_state(recipe.amax_history_len, shape=(cfg.num_layers,),
                                           device=device)
                       for t in ("x", "w", "g")}
    return state


def forward_scales(qstate: Dict[str, Dict[str, ScaleState]], cfg: ModelConfig, device="cpu"
                   ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-site ``(x_scale [L], w_scale [L])`` for ``forward_fp8_train``."""
    ones = torch.ones((cfg.num_layers,), dtype=torch.float32, device=device)
    return {site: ((qstate[site]["x"].scale, qstate[site]["w"].scale) if site in qstate
                   else (ones, ones)) for site in DOT_SITES}


def make_sinks(cfg: ModelConfig, device="cpu") -> Dict[str, torch.Tensor]:
    """Zero amax sinks ``[L]`` that require a gradient; their gradients
    carry the backward amaxes out."""
    return {s: torch.zeros((cfg.num_layers,), dtype=torch.float32, device=device,
                           requires_grad=True) for s in DOT_SITES}


def _finite(a: torch.Tensor) -> torch.Tensor:
    # A non-finite amax would make the scale inf and dequant NaN; with
    # amax_compute='max' the poisoned history regenerates itself. Dropping
    # the observation (0 never wins the max) is the safe fold.
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def update_quant_state(qstate: Dict[str, Dict[str, ScaleState]], amaxes: Dict[str, DotAmaxes],
                       g_amaxes: Dict[str, torch.Tensor], recipes: RecipeSet
                       ) -> Dict[str, Dict[str, ScaleState]]:
    """Fold this step's observations (``amaxes[site]`` stacked ``[L]`` from
    the forward, ``g_amaxes[site]`` ``[L]`` from the sinks) into new state."""
    new = {}
    for site, st in qstate.items():
        recipe = recipes.for_role(SITE_ROLE[site])
        obs = {"x": amaxes[site].x, "w": amaxes[site].w, "g": g_amaxes[site]}
        fmts = {"x": recipe.fmt_fwd, "w": recipe.fmt_fwd, "g": recipe.fmt_bwd}
        new[site] = {t: observe_amax(st[t], _finite(obs[t].detach().float()), fmts[t],
                                     amax_compute=recipe.amax_compute, margin=recipe.margin)
                     for t in ("x", "w", "g")}
    return new
