"""BASE's context-parallel train step in plain PyTorch, unsharded, for the
check of a cell that splits each image's rows over ranks.

What the step under test computes on the global batch of D·B images, which
every rank passes whole and each runs on its block of rows: the BatchNorms
normalise each domain's samples with that domain's moments over the whole
batch (``model.BN`` with the one-hots); the loss is BCE + squared-denominator
dice formed from sums over every value of the global batch (the mean BCE and
one dice of the whole batch); one backward pull; AdamW (``train.AdamW``).
Dropout and stochastic depth draw one seed a call site from a CPU generator
(``rng.SeedTape``) and hash the unsharded tensor's counters, so the masks are
those of one process on the whole batch; the augmentation draws the whole
batch's values from a generator on the card, as the step's caller does.

Where it departs from ``train.Step`` (the single-card cells' reference):
that step sums the domains' losses, Σ_d (mean BCE_d + dice_d), the
single-card step's objective; this one takes one loss of the whole batch.
With equal domains the BCE term is that sum's over D, and the dice is one
dice of the whole batch's sums, not D dices. No StepLR step is taken: the
step under test takes none, and over the compared steps the rate is the
first either way.

Blocked over depth: at 1024² the whole batch's activations (~150 GB) do not
fit on one card, so every stem conv, patch embed, attention block, the
bridge, each decoder's merge and the head run under non-reentrant
``torch.utils.checkpoint``: only each piece's input is kept, and the backward
recomputes one piece at a time. Element dropout hashes int64 counters of
every value (``rng.keep_mask``): an MLP's hidden dropout at 1024², 1.07 G
values, set the peak at ~71 GB of a card, so the blocked step hashes
``SAMPLES`` samples at a time (``_dropout_in_slices``: the same counters,
the same masks). A recompute replays the seed tape from where the piece's
forward found it (``_Replay``), so it draws the same masks, and the
recomputed values are the forward's bits: the blocked step is bit-equal to
the unblocked one (``blocked=False``, the whole batch at once).

Two planted faults for the limits of the check, in place of the step under
test: ``"half"`` leaves out each domain's second half of rows (the loss over
the rest), and ``"rows_alone"`` runs each rank's block of rows of every image
as an image of its own: no halo, no gather, attention within the block,
zero pads and resizes at its edges; the BatchNorm moments, the loss and the
masks are the whole batch's (stochastic depth keeps one draw an image).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import model as ref_model
from portbench.reference import rng
from portbench.reference import train as ref_train
from portbench.reference.model import Ctx, Model, conv, resize

# the samples of one slice of a dropout's mask in the blocked step
SAMPLES = 8


class _Replay:
    """A piece's recompute context: the seed tape at the position the
    piece's forward found, and back where the recompute found it."""

    def __init__(self, tape: rng.SeedTape | None, pos: int):
        self.tape, self.pos = tape, pos

    def __enter__(self) -> None:
        if self.tape is not None:
            self.resume, self.tape.pos = self.tape.pos, self.pos

    def __exit__(self, *exc) -> None:
        if self.tape is not None:
            self.tape.pos = self.resume


def _piece(fn, ctx: Ctx, blocked: bool, *tensors):
    """``fn(*tensors)``, under checkpoint when ``blocked``."""
    if not blocked:
        return fn(*tensors)
    pos = ctx.tape.pos if ctx.tape is not None else 0
    return checkpoint(fn, *tensors, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _Replay(ctx.tape, pos)))


def forward(model: Model, x: torch.Tensor, onehot: torch.Tensor, ctx: Ctx,
            blocked: bool = True) -> torch.Tensor:
    """BASE's logits (B, H, W, 1) of normalised NHWC ``x``: ``Model.forward``
    piece by piece (every piece checkpointed when ``blocked``)."""
    if model.kind != "base":
        raise ValueError("the context-parallel reference is BASE's")
    hw = tuple(x.shape[1:3])
    for m in model.stem:
        x = _piece(lambda t, m=m: m(t, onehot, ctx), ctx, blocked, x)
    skips = []

    def stage_run(stage, t, size):
        for blk in stage.mhca_blks:
            t = _piece(lambda u, blk=blk: blk(u, size, onehot, stage.cpe, stage.crpe, ctx),
                       ctx, blocked, t)
        return t

    for embed, stage in zip(model.patch_embed_stages, model.mhsa_stages):
        x = _piece(lambda t, embed=embed: embed(t, onehot, ctx), ctx, blocked, x)
        size = tuple(x.shape[1:3])
        x = stage_run(stage, x.flatten(1, 2), size).unflatten(1, size)
        skips.append(x)

    def bridge(t):
        c1, b1, _, c2, b2, _ = model.bridge
        t = F.relu(b1(conv(t, c1), onehot, ctx))
        return F.relu(b2(conv(t, c2), onehot, ctx))

    out = _piece(bridge, ctx, blocked, skips[3])
    for n in range(1, 5):
        dec = getattr(model, f"decoder{n}")
        skip = skips[4 - n]
        size = tuple(skip.shape[1:3])

        def merge(t, s, dec=dec, size=size):
            t = torch.cat([s, resize(conv(t, dec.conv_before), size)], dim=-1)
            return dec.conv_after(t, onehot, ctx)

        out = _piece(merge, ctx, blocked, out, skip)
        out = stage_run(dec.mhsa_block, out.flatten(1, 2), size).unflatten(1, size)
    return _piece(lambda t: resize(conv(t, model.finalconv[0]), hw), ctx, blocked, out)


@contextlib.contextmanager
def _dropout_in_slices(samples: int):
    """Element dropout a slice of ``samples`` samples at a time: the same
    counters, so the same masks and bits, with the int64 hashing of a slice
    alive at once instead of the whole tensor's."""
    plain = ref_model._dropout

    def dropout(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        if not (ctx.tape and ctx.drop):
            return x
        seed = ctx.tape.next()
        return torch.cat([rng.dropout(x[s:s + samples], ctx.drop, seed, ctx.row0 + s)
                          for s in range(0, x.shape[0], samples)])

    ref_model._dropout = dropout
    try:
        yield
    finally:
        ref_model._dropout = plain


@contextlib.contextmanager
def _drop_path_per_image(slices: int):
    """Stochastic depth keeping one draw an image of ``slices`` consecutive
    samples (``"rows_alone"``: an image's blocks of rows are its samples)."""
    plain = ref_model._drop_path

    def drop_path(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        if not (ctx.tape and ctx.drop_path):
            return x
        keep = 1.0 - ctx.drop_path
        shape = (x.shape[0] // slices,) + (1,) * (x.dim() - 1)
        mask = rng.keep_mask(keep, shape, ctx.tape.next(), x.device, ctx.row0 // slices)
        return torch.where(mask.repeat_interleave(slices, 0), x / keep, torch.zeros_like(x))

    ref_model._drop_path = drop_path
    try:
        yield
    finally:
        ref_model._drop_path = plain


class Step:
    """The reference's context-parallel train step over ``model`` and the
    per-domain uint8 stores; ``seed`` seeds its dropout generator (CPU) and
    its augmentation generator (the stores' device), as the step's caller
    seeds the step's; ``ranks``: the ranks the rows are split over (the
    ``"rows_alone"`` fault's blocks)."""

    def __init__(self, model: Model, cfg: dict, steps_per_epoch: int, seed: int,
                 ranks: int = 1, blocked: bool = True, samples: int = SAMPLES):
        self.model, self.cfg, self.ranks, self.blocked = model, cfg, ranks, blocked
        self.samples = samples
        self.named = list(model.named_parameters())
        self.params = [p for _, p in self.named]
        self.opt = ref_train.AdamW(self.params, cfg["optimizer"], steps_per_epoch)
        self.gen = torch.Generator().manual_seed(seed)
        self.aug_gen = torch.Generator(device=self.params[0].device).manual_seed(seed)

    def batch(self, images, masks, indices: torch.Tensor):
        """(normalised images, labels (D·B, H, W, 1), one-hots) of the global
        batch ``indices`` (D, B) selects, augmented a domain's rows at a time."""
        d, b = indices.shape
        p = rng.aug_params(self.aug_gen, d * b, self.params[0].device)
        xs, ys = zip(*(rng.augment(images[i][indices[i]].float(), masks[i][indices[i]].float(),
                                   p, i * b) for i in range(d)))
        onehot = F.one_hot(torch.arange(d * b, device=indices.device) // b, self.model.domains)
        return torch.cat(xs), torch.cat(ys), onehot.float()

    def grads(self, images, masks, indices: torch.Tensor, fault: str | None = None):
        """(the loss, a 0-d tensor; gradients) of one step's batch, before the
        update; ``fault``: None, ``"half"`` or ``"rows_alone"``."""
        d, b = indices.shape
        x, y, onehot = self.batch(images, masks, indices)
        if fault == "half":
            rows = torch.arange(d * b, device=x.device).view(d, b)[:, :b // 2].reshape(-1)
            x, y, onehot = x[rows], y[rows], onehot[rows]
        tape = rng.SeedTape(self.gen)
        ctx = Ctx(tape, 0, self.cfg["drop_rate"], self.cfg["drop_path_rate"])
        n = self.ranks if fault == "rows_alone" else 1
        with contextlib.ExitStack() as patched:
            if self.blocked:
                patched.enter_context(_dropout_in_slices(self.samples * n))
            if n > 1:
                patched.enter_context(_drop_path_per_image(n))
                bb, h, w, c = x.shape
                x, onehot = x.reshape(bb * n, h // n, w, c), onehot.repeat_interleave(n, 0)
            logits = forward(self.model, x, onehot, ctx, self.blocked).reshape(y.shape)
            loss = ref_train.seg_loss(logits, y)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(q) if g is None else g
                               for q, g in zip(self.params, grads)]

    def __call__(self, images, masks, indices, fault: str | None = None):
        """One step: (the loss, gradients as the update took them)."""
        loss, grads = self.grads(images, masks, indices, fault)
        self.opt.step(grads)
        return float(loss), grads
