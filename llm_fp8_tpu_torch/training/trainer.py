"""FP8 fine-tuning trainer (counterpart of ``llm_fp8_tpu/training/trainer.py``).

One train step: the forward (``forward_fp8_train`` under an FP8 recipe set,
``forward`` under bf16), the loss, the gradients of the float32 master
weights and of the amax sinks, then the optimizer and the delayed-scaling
update. The optimizer is optax's chain written out in torch:
``clip_by_global_norm`` → AdamW (``scale_by_adam`` with its bias correction,
decay masked off norms, biases and ``bqkv``, optional ``adam_mu_dtype``) →
the learning-rate schedule (linear warmup then linear decay, warmup then
cosine, or constant), wrapped in ``MultiSteps`` for ``grad_accum``.

Where JAX donates the state to a jitted step, ``train_step`` updates the
given state in place and returns it. The non-finite guard reads the loss and
the gradient norm on the host: a non-finite step leaves the parameters, the
optimizer state (Adam's count included) and the delayed-scaling state as
they were, and only the step counter moves on. ``remat`` (``none``/False,
``full``/True, ``dots``) checkpoints each layer (``models/llama.py``);
``attention_dropout`` drops softmax weights with the step as the seed, as
JAX passes ``dropout_seed=step``, on the bf16 recipe: the JAX trainer gives
it to the bf16 forward only, so the port refuses it with an fp8 recipe
rather than train otherwise than the reference. ``unroll`` (a JAX scan knob)
has no counterpart in an eager loop over the layers and must stay 1.

``forward_fn`` trains another family through the same steps, as the JAX
trainer's: any forward with the zoo signature ``fn(params, tokens, cfg,
remat=, dropout_p=, dropout_seed=) -> logits`` (the GPT-2, NeoX, Gemma-2,
MoE and MLA families, ``models/registry.py``; Gemma-2 casts each dot's float32 master
weight to bf16, as JAX's ``_dot``), on the bf16 recipe only (the FP8 recipes implement
the Llama stack). Such a forward exposes no hidden states, so the loss is
never chunked and the activation mean and std are NaN (``StabilityTracker``
skips them); its float32 params must carry no float32 head copy
(``models/zoo.py::HEAD_F32``), which would take the head's gradient away from
the tied embedding. A forward that returns a tuple (the MoE and MLA families'
``(logits, cache[, aux])``, JAX's convention) gives its first value. A config
with ``router_aux_coef`` is an MoE config (MLA's DeepSeekMoE too): its forward is called with
``return_router_aux=True`` and ``token_mask=attention_mask`` (padding claims
no expert capacity and stays out of the router statistics), and
``router_aux_coef · aux`` joins the loss, as JAX's trainer adds it; the
step's aux is ``Trainer.router_aux`` after the forward and ``router_aux`` in
``train_step``'s metrics.

``mesh`` (``parallel/mesh.py::make_mesh``) trains the Llama family over a
``torch.distributed`` world, as JAX's GSPMD program does over its mesh:
``dp`` and ``fsdp`` cut the global batch's rows (``batch_spec``), ``cp``
rings attention over the sequence (``ops/attention.py``). Parameters and
the AdamW state are ``DTensor``s sharded by ``parallel/sharding.py``; each
layer's weights are all-gathered just before the layer runs, the gradients
reduce-scattered (``parallel/fsdp.py``) and summed over the data ranks.
Every quantity JAX reduces over the whole batch is reduced over the data
ranks: the loss's token count (each rank's loss is its sum over the global
count, their sum the loss), the global gradient norm that clips, the
activation statistics, the delayed-scaling amaxes (MAX, before ``qstate``
moves) and the row-wise just-in-time gradient scales of the fp8 dots
(``quant/dot.py::rows_split_over``). ``tp``, ``ep`` and ``pp`` above 1 and
the other families raise. Every rank passes the same global batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.llama import _lm_head, remat_mode, forward, forward_fp8_train, lm_head_weight
from ..models.zoo import HEAD_F32
from ..quant import RecipeSet, recipe_set_by_name
from ..quant.dot import rows_split_over
from ..utils.backend import resolve_device
from .losses import causal_lm_loss, chunked_causal_lm_loss, token_count
from .quant_state import forward_scales, init_train_quant_state, make_sinks, update_quant_state

__all__ = ["TrainConfig", "TrainState", "Trainer", "make_optimizer", "AdamW"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run hyperparameters (the JAX ``TrainConfig``'s fields)."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "linear"  # "linear" | "cosine" | "constant"
    grad_clip: float = 1.0
    grad_accum: int = 1
    recipes: str = "bf16"  # recipe-set name: default|hybrid|mxfp8|int8_train|bf16
    z_loss: float = 0.0
    label_smoothing: float = 0.0
    unroll: int = 1  # a JAX scan knob: must stay 1 here
    remat: Any = False  # False/"none", True/"full" or "dots"
    adam_mu_dtype: Optional[str] = None
    attention_dropout: float = 0.0  # softmax-weight dropout, seeded by the step
    ce_chunks: int = 0


@dataclasses.dataclass
class OptState:
    """AdamW's moments and count, and ``MultiSteps``' accumulator."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0
    acc: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: OptState
    qstate: Any  # delayed-scaling state ({} when the recipe set is off)
    step: int


def _leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` in JAX's pytree order (dict keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.extend(_leaves(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def _local(t):
    """A DTensor's local slice (sharing its storage); any other tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b": x}`` back to ``{"a": {"b": x}}``."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _no_decay(path: str) -> bool:
    # Norm weights and biases are excluded from weight decay.
    name = path.rsplit("/", 1)[-1]
    return any(t in name for t in ("norm", "bqkv", "bias"))


def _polynomial(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax ``linear_schedule`` in float32 (constant ``init`` when
    ``steps <= 0``)."""
    if steps <= 0:
        return np.float32(init)
    c = min(max(count, 0), steps)
    frac = np.float32(1) - np.float32(c) / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def _cosine(init: float, decay_steps: int, count: int) -> np.float32:
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay steps, got {decay_steps}")
    c = min(np.float32(count), np.float32(decay_steps))
    cos = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c / np.float32(decay_steps)))
    return np.float32(init) * cos


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw(schedule, mask))``, wrapped
    in ``MultiSteps`` when ``grad_accum > 1``; updates parameters in place."""

    def __init__(self, config: TrainConfig):
        if config.schedule not in ("linear", "cosine", "constant"):
            raise ValueError(f"unknown schedule {config.schedule!r}")
        self.cfg = config
        self.mu_dtype = (None if config.adam_mu_dtype is None
                         else getattr(torch, str(config.adam_mu_dtype)))
        if config.schedule == "cosine":
            _cosine(config.learning_rate, config.total_steps - config.warmup_steps, 0)

    def learning_rate(self, count: int) -> np.float32:
        c = self.cfg
        w = c.warmup_steps
        if c.schedule == "linear":
            if count < w:
                return _polynomial(0.0, c.learning_rate, w, count)
            return _polynomial(c.learning_rate, 0.0, max(c.total_steps - w, 1), count - w)
        if c.schedule == "cosine":
            if count < w:
                return _polynomial(0.0, c.learning_rate, w, count)
            return _cosine(c.learning_rate, c.total_steps - w, count - w)
        return np.float32(c.learning_rate)

    def init(self, params) -> OptState:
        leaves = _leaves(params)
        mu = {p: torch.zeros_like(t, dtype=self.mu_dtype or t.dtype) for p, t in leaves}
        nu = {p: torch.zeros_like(t) for p, t in leaves}
        acc = ({p: torch.zeros_like(t, dtype=torch.float32) for p, t in leaves}
               if self.cfg.grad_accum > 1 else None)
        return OptState(count=0, mu=mu, nu=nu, acc=acc)

    @torch.no_grad()
    def step(self, params, grads: Dict[str, torch.Tensor], state: OptState,
             norm=None) -> None:
        """One update of ``params`` and ``state`` in place from ``grads``
        (path → gradient; a DTensor's local slice for a DTensor parameter,
        whose state is updated in its local slices). ``norm``: the global
        gradient norm of a ``{path: gradient}`` dict's values."""
        k = self.cfg.grad_accum
        if k > 1:
            n = state.mini_step
            for p, g in grads.items():
                a = _local(state.acc[p])
                a.copy_(a + (g.float() - a) / (n + 1))
            state.mini_step = (n + 1) % k
            if n != k - 1:
                return
            grads = {p: _local(a) for p, a in state.acc.items()}
        self._apply(params, grads, state,
                    norm(grads) if norm is not None else global_norm(grads.values()))
        if k > 1:
            for a in state.acc.values():
                _local(a).zero_()

    def _apply(self, params, grads, state: OptState, g_norm) -> None:
        c = self.cfg
        clip = not bool(g_norm < c.grad_clip)
        lr = -self.learning_rate(state.count)
        count = state.count + 1
        dev = g_norm.device
        bc1 = 1 - torch.tensor(c.adam_b1, dtype=torch.float32, device=dev) ** count
        bc2 = 1 - torch.tensor(c.adam_b2, dtype=torch.float32, device=dev) ** count
        for path, p in _leaves(params):
            g, p = grads[path], _local(p)
            m_old, n_old = _local(state.mu[path]), _local(state.nu[path])
            if clip:
                g = (g / g_norm.to(g.dtype)) * c.grad_clip
            mu = (1 - c.adam_b1) * g + c.adam_b1 * m_old.float()
            nu = (1 - c.adam_b2) * (g * g) + c.adam_b2 * n_old
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.adam_eps)
            if not _no_decay(path):
                u = u + c.weight_decay * p
            p.copy_(p + float(lr) * u)
            m_old.copy_(mu)
            n_old.copy_(nu)
        state.count = count


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ Σ x²)`` over all tensors, float32 (optax ``global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_optimizer(config: TrainConfig) -> AdamW:
    return AdamW(config)


def _batch_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


class Trainer:
    """The train and eval steps of one model configuration on one device."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, *, device=None,
                 forward_fn=None, mesh=None):
        """``forward_fn``: the family's forward (default: the Llama
        family's); another family trains on the bf16 recipe only. ``mesh``:
        a ``DeviceMesh`` of the world to train over (module docstring)."""
        remat_mode(train_cfg.remat)  # raises on an unknown policy
        if train_cfg.unroll != 1:
            raise NotImplementedError("Trainer: unroll is a JAX scan knob; the port's "
                                      "layer loop has no counterpart (leave it at 1)")
        if not 0.0 <= train_cfg.attention_dropout < 1.0:
            raise ValueError(f"attention_dropout {train_cfg.attention_dropout} outside [0, 1)")
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.recipes: RecipeSet = recipe_set_by_name(train_cfg.recipes)
        self._fwd = forward_fn if forward_fn is not None else forward
        self._llama = self._fwd is forward
        self._moe = hasattr(model_cfg, "router_aux_coef")
        self.router_aux = None
        if self.recipes.enabled and not self._llama:
            raise ValueError("FP8 recipe training implements the Llama/Qwen family stack; "
                             "train other zoo families with recipes='bf16'")
        if train_cfg.attention_dropout and self.recipes.enabled:
            raise ValueError(f"attention_dropout applies to the bf16 recipe only (the JAX "
                             f"trainer leaves it out of the fp8 forward); recipes "
                             f"{train_cfg.recipes!r} with attention_dropout "
                             f"{train_cfg.attention_dropout}")
        self.tx = make_optimizer(train_cfg)
        self.mesh = mesh
        if mesh is not None:
            self._init_mesh(mesh)

    def _init_mesh(self, mesh) -> None:
        from ..parallel.mesh import axis_sizes, data_group, data_index

        sizes = axis_sizes(mesh)
        if sizes["tp"] > 1 or sizes["ep"] > 1:
            raise NotImplementedError(
                f"tp {sizes['tp']} / ep {sizes['ep']}: tensor and expert parallelism "
                "(column/row-parallel products, the experts' all-to-all) are not ported yet; "
                "the trainer takes dp, fsdp and cp")
        if sizes["pp"] > 1:
            raise NotImplementedError("the trainer takes dp, fsdp and cp; the pipeline is "
                                      "parallel/pipeline.py::forward_pipelined")
        if not self._llama:
            raise NotImplementedError("training over a mesh takes the Llama family")
        self.data_group = data_group(mesh)
        # cp 1 keeps the plain attention call (the ring of one rank is K3
        # over the whole sequence, as on the card, but not the CPU's golden).
        self.cp_group = mesh.get_group("cp") if sizes["cp"] > 1 else None
        self.data_ranks = (data_index(mesh), sizes["dp"] * sizes["fsdp"])

    # ---- state ----

    def init_state(self, params) -> TrainState:
        """Takes float32 master weights on the trainer's device (they become
        leaves that require a gradient and are updated in place; over a mesh,
        a full tree is sharded here, or ``shard_params``'s DTensors are taken
        as they are, and each step's leaves are their local slices). A tree with
        a float32 head copy (:data:`~..models.zoo.HEAD_F32`, a serving
        engine's) is refused."""
        if HEAD_F32 in params:
            raise ValueError(f"the parameter tree carries {HEAD_F32!r}, a serving engine's "
                             "float32 head copy: a trained copy would take the head's "
                             "gradient away from the tied embedding; train the tree "
                             "without it")
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        if self.mesh is not None:
            from ..parallel.sharding import param_specs, shard_params

            if not all(hasattr(t, "to_local") for _, t in _leaves(params)):
                params = shard_params(params, self.mesh)
            self.specs = dict(_leaves(param_specs(params, self.mesh)))
        for path, t in _leaves(params):
            if _local(t).device != want:
                raise ValueError(f"parameter {path} is on {t.device}, the trainer on "
                                 f"{self.device}")
            if self.mesh is None:
                t.requires_grad_(True)
        qstate = (init_train_quant_state(self.model_cfg, self.recipes, self.device)
                  if self.recipes.enabled else {})
        return TrainState(params=params, opt_state=self.tx.init(params), qstate=qstate,
                          step=0)

    # ---- steps ----

    def _rows(self, batch) -> Dict[str, Any]:
        """This rank's rows of a global batch (the data ranks cut it in
        order, ``dp`` major); the whole batch without a mesh."""
        if self.mesh is None:
            return batch
        r, n = self.data_ranks
        B = len(batch["input_ids"])
        if B % n:
            raise ValueError(f"a batch of {B} rows over {n} data ranks")
        return {k: v[r * B // n:(r + 1) * B // n] for k, v in batch.items()}

    def _forward_loss(self, params, sinks, batch, qstate, step: int = 0, n_total=None):
        tokens = _batch_tensor(batch["input_ids"], self.device)
        mask = batch.get("attention_mask")
        mask = None if mask is None else _batch_tensor(mask, self.device)
        kw = dict(z_loss=self.cfg.z_loss, label_smoothing=self.cfg.label_smoothing)
        if not self._llama:
            # No hidden states from a zoo forward: no chunked loss and no
            # activation series (NaN, as the JAX trainer's).
            fkw = dict(remat=self.cfg.remat, dropout_p=self.cfg.attention_dropout,
                       dropout_seed=step)
            if self._moe:
                fkw.update(return_router_aux=True, token_mask=mask)
            out = self._fwd(params, tokens, self.model_cfg, **fkw)
            logits = out[0] if isinstance(out, tuple) else out
            nan = torch.full((), float("nan"), device=self.device)
            loss, n = causal_lm_loss(logits, tokens, mask, **kw)
            if self._moe:
                self.router_aux = out[2].detach()
                loss = loss + self.model_cfg.router_aux_coef * out[2]
            return loss, n, {}, (nan, nan)
        kw = dict(return_hidden=True, remat=self.cfg.remat)
        if self.mesh is not None:
            kw.update(cp_group=self.cp_group)
        if self.recipes.enabled:
            scales = forward_scales(qstate, self.model_cfg, self.device)
            hidden, amaxes = forward_fp8_train(params, tokens, self.model_cfg, self.recipes,
                                               scales, sinks, **kw)
        else:
            hidden, _ = forward(params, tokens, self.model_cfg,
                                dropout_p=self.cfg.attention_dropout, dropout_seed=step, **kw)
            amaxes = {}
        act_stats = self._act_stats(hidden)
        kw = dict(z_loss=self.cfg.z_loss, label_smoothing=self.cfg.label_smoothing,
                  n_total=n_total)
        if self.cfg.ce_chunks > 1:
            loss, n = chunked_causal_lm_loss(hidden, lm_head_weight(params, self.model_cfg),
                                             tokens, mask, num_chunks=self.cfg.ce_chunks, **kw)
        else:
            loss, n = causal_lm_loss(_lm_head(params, hidden, self.model_cfg), tokens, mask,
                                     **kw)
        return loss, n, amaxes, act_stats

    @torch.no_grad()
    def _act_stats(self, hidden):
        """The final hidden states' mean and (population) std, over the
        whole batch of the world."""
        h = hidden.float()
        group = self.data_group if self.mesh is not None else None
        if group is None or dist.get_world_size(group) == 1:
            return h.mean(), h.std(unbiased=False)
        s = torch.stack([h.sum(), torch.tensor(float(h.numel()), device=h.device)])
        dist.all_reduce(s, group=group)
        mean = s[0] / s[1]
        ss = (h - mean).square().sum()
        dist.all_reduce(ss, group=group)
        return mean, torch.sqrt(ss / s[1])

    def loss_and_grads(self, state: TrainState, batch):
        """The step's forward and backward without the update: ``(loss,
        tokens, amaxes {site: DotAmaxes [L]}, (activation mean, std),
        {path: parameter gradient}, {site: backward amaxes [L]})``. Over a
        mesh: the world's loss, count and amaxes, and each gradient of this
        rank's parameter slice, summed over the world."""
        if self.mesh is not None:
            return self._mesh_loss_and_grads(state, batch)
        sinks = make_sinks(self.model_cfg, self.device) if self.recipes.enabled else {}
        loss, n, amaxes, act_stats = self._forward_loss(state.params, sinks, batch,
                                                        state.qstate, state.step)
        leaves = _leaves(state.params)
        wrt = [t for _, t in leaves] + list(sinks.values())
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
        pgrads = {path: g for (path, _), g in zip(leaves, grads)}
        g_amaxes = dict(zip(sinks, grads[len(leaves):]))
        return loss.detach(), n, amaxes, act_stats, pgrads, g_amaxes

    def _mesh_leaves(self, params):
        """``[(path, leaf)]``: this rank's slices as fresh leaves that share
        the parameters' storage and require a gradient."""
        with torch.no_grad():
            return [(p, _local(t).detach().requires_grad_(True)) for p, t in _leaves(params)]

    def _mesh_loss_and_grads(self, state: TrainState, batch):
        from ..parallel.fsdp import forward_tree, reduce_grads

        batch = self._rows(batch)
        tokens = _batch_tensor(batch["input_ids"], self.device)
        mask = batch.get("attention_mask")
        n_total = token_count(tokens, None if mask is None else _batch_tensor(mask, self.device))
        dist.all_reduce(n_total, group=self.data_group)
        n_total = n_total.clamp(min=1)
        sinks = make_sinks(self.model_cfg, self.device) if self.recipes.enabled else {}
        leaves = self._mesh_leaves(state.params)
        specs = _nest(self.specs)
        with rows_split_over(self.data_group):
            params = forward_tree(_nest(dict(leaves)), specs, self.mesh)
            loss, n, amaxes, act_stats = self._forward_loss(params, sinks, batch, state.qstate,
                                                            state.step, n_total)
            wrt = [t for _, t in leaves] + list(sinks.values())
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
        pgrads = {path: g for (path, _), g in zip(leaves, grads)}
        reduce_grads(pgrads, self.specs, self.mesh, self.data_group)
        g_amaxes = dict(zip(sinks, grads[len(leaves):]))
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=self.data_group)
        if amaxes:
            self._reduce_amaxes(amaxes, g_amaxes)
        return loss, n, amaxes, act_stats, pgrads, g_amaxes

    def _reduce_amaxes(self, amaxes, g_amaxes) -> None:
        """The world's amaxes, in place: MAX over the data ranks (one
        all-reduce for every site's forward and backward amaxes)."""
        sites = sorted(amaxes)
        flat = torch.stack([t for s in sites for t in (amaxes[s].x, amaxes[s].w, g_amaxes[s])])
        dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=self.data_group)
        parts = iter(flat.unbind(0))
        for s in sites:
            amaxes[s] = amaxes[s]._replace(x=next(parts), w=next(parts))
            g_amaxes[s] = next(parts)

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global gradient norm: over a mesh each slice's sum of squares
        is summed over the ranks that hold the other slices of its leaf,
        then the leaves are summed in :func:`global_norm`'s order."""
        if self.mesh is None:
            return global_norm(grads.values())
        from ..parallel.fsdp import sharded_axes

        sq = [g.float().square().sum() for g in grads.values()]
        sharded = [i for i, p in enumerate(grads) if "fsdp" in sharded_axes(self.specs[p])]
        if sharded:
            vec = torch.stack([sq[i] for i in sharded])
            dist.all_reduce(vec, group=self.mesh.get_group("fsdp"))
            for i, v in zip(sharded, vec.unbind(0)):
                sq[i] = v
        return torch.sqrt(sum(sq))

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        """One step on a batch (numpy or torch ``input_ids`` and
        ``attention_mask``); returns the updated ``state`` and the step's
        metrics (0-d tensors: loss, grad_norm, tokens, finite,
        activation_mean, activation_std; an MoE model's router_aux). Over a
        mesh every rank passes the same global batch."""
        loss, n, amaxes, act_stats, pgrads, g_amaxes = self.loss_and_grads(state, batch)
        gnorm = self._grad_norm(pgrads)
        finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
        if finite:
            self.tx.step(state.params, pgrads, state.opt_state, norm=self._grad_norm)
            if state.qstate:
                state.qstate = update_quant_state(state.qstate, amaxes, g_amaxes,
                                                  self.recipes)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": gnorm, "tokens": n,
                   "finite": torch.tensor(int(finite)),
                   "activation_mean": act_stats[0], "activation_std": act_stats[1]}
        if self._moe:
            metrics["router_aux"] = self.router_aux
        return state, metrics

    @torch.no_grad()
    def _eval_step(self, params, batch):
        if self.mesh is not None:
            return self._mesh_eval_step(params, batch)
        tokens = _batch_tensor(batch["input_ids"], self.device)
        mask = batch.get("attention_mask")
        mask = None if mask is None else _batch_tensor(mask, self.device)
        if not self._llama:
            out = self._fwd(params, tokens, self.model_cfg)
            loss, n = causal_lm_loss(out[0] if isinstance(out, tuple) else out, tokens, mask)
            return loss * n, n
        chunked = self.cfg.ce_chunks > 1
        out, _ = forward(params, tokens, self.model_cfg, return_hidden=chunked)
        if chunked:
            loss, n = chunked_causal_lm_loss(out, lm_head_weight(params, self.model_cfg),
                                             tokens, mask, num_chunks=self.cfg.ce_chunks)
        else:
            loss, n = causal_lm_loss(out, tokens, mask)
        return loss * n, n

    def _mesh_eval_step(self, full, batch):
        """The eval step over a mesh (``full``: the gathered parameters): the
        data ranks share a batch whose rows they divide (summing their
        token-weighted losses); a smaller or uneven batch runs whole on
        every rank."""
        _, n_ranks = self.data_ranks
        B = len(batch["input_ids"])
        split = B % n_ranks == 0
        if split:
            batch = self._rows(batch)
        tokens = _batch_tensor(batch["input_ids"], self.device)
        mask = batch.get("attention_mask")
        mask = None if mask is None else _batch_tensor(mask, self.device)
        chunked = self.cfg.ce_chunks > 1
        out, _ = forward(full, tokens, self.model_cfg, return_hidden=chunked,
                         cp_group=self.cp_group)
        if chunked:
            loss, n = chunked_causal_lm_loss(out, lm_head_weight(full, self.model_cfg),
                                             tokens, mask, num_chunks=self.cfg.ce_chunks)
        else:
            loss, n = causal_lm_loss(out, tokens, mask)
        pair = torch.stack([loss * n, n.to(loss.dtype)])
        if split:
            dist.all_reduce(pair, group=self.data_group)
        return pair[0], pair[1]

    def evaluate(self, params, batches: Iterable[Dict]) -> Dict[str, float]:
        """Token-weighted eval loss → perplexity (capped at exp(20)). Over a
        mesh every rank calls it with the same batches; the parameters are
        gathered once."""
        if self.mesh is not None:
            from ..parallel.sharding import gather_tree

            params = gather_tree(params)
        total_loss, total_tokens = 0.0, 0
        for batch in batches:
            loss, n = self._eval_step(params, batch)
            total_loss += float(loss)
            total_tokens += int(n)
        mean = total_loss / max(total_tokens, 1)
        return {"eval_loss": mean, "perplexity": math.exp(min(mean, 20.0)),
                "eval_tokens": total_tokens}
