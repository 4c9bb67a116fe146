"""Speculative decoding with exact greedy acceptance: the port of
``tpudml/serve/spec.py``.

A small DRAFT model proposes K tokens autoregressively, then the target
scores the whole K+1-token window in ONE pass (``apply_decode_window``, or
``apply_decode_paged`` over the page pool). Greedy acceptance keeps the
longest prefix where the draft's token equals the target's argmax and
emits the TARGET's token at the first mismatch (or the bonus K+1-th token
when all match), so the committed stream is exactly what pure target
greedy decoding produces. Every accepted draft token is a target decode
step the engine did not run.

The window is K+1 tokens for every slot every step; the step returns
``(emitted [B, K+1], n_emit [B], logits [B, K+1, V])`` and the host
commits the first ``n_emit`` per slot. Rejected rows leave stale K/V at
positions >= the commit point in BOTH caches; the next window starts at
the commit point and rewrites every such row before the mask exposes it.

The default draft is a layer-truncated view of the target
(``draft_from_trunk``): its first blocks with the shared embedding, final
norm and head — no second set of weights.
"""

from __future__ import annotations

import copy

import torch


def draft_from_trunk(model, num_layers: int):
    """(draft_model, draft_params): a ``TransformerLM`` view of the
    target's first ``num_layers`` blocks that shares the target's
    embedding, final norm, head and block modules (no weight is copied),
    and its parameters by name (the target's own tensors)."""
    if not 1 <= num_layers < model.num_layers:
        raise ValueError(
            f"draft num_layers must be in [1, {model.num_layers}), got {num_layers}"
        )
    draft = copy.copy(model)  # the same submodules and parameters
    draft._parameters = dict(model._parameters)
    draft._buffers = dict(model._buffers)
    draft._modules = {name: m for name, m in model._modules.items()
                      if not name.startswith("block") or int(name[5:]) < num_layers}
    draft.num_layers = num_layers
    return draft, dict(draft.named_parameters())


def _verify(window, logits, spec_k: int):
    """Greedy acceptance over the scored window. ``window`` [B, K+1] is
    [t0, d1..dK]; ``logits`` [B, K+1, V] row j predicts position pos+j+1.
    Returns (emitted [B, K+1] int32, n_emit [B]): ``emitted`` is the
    target's greedy token at every row (``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does); its first ``accepted`` entries equal
    the draft's, entry ``accepted`` is the correction or the bonus."""
    emitted = torch.argmax(logits, dim=-1).to(torch.int32)
    match = (window[:, 1:] == emitted[:, :spec_k]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1)
    return emitted, accepted + 1


def make_spec_decode_step(model, draft_model, spec_k: int, *, paged: bool = False):
    """The spec-decode step. Dense signature ``(caches, dcaches, tokens [B],
    pos [B])``; paged inserts ``table`` [B, max_pages] after ``dcaches``
    (the DRAFT cache stays dense in every mode). Returns ``(emitted
    [B, K+1], n_emit [B], logits [B, K+1, V])``; both caches update in
    place."""
    if spec_k < 1:
        raise ValueError("spec_k must be >= 1")

    def _draft_window(dcaches, tokens, pos):
        """K draft decode steps: [t0, d1..dK], the draft cache advanced
        through every window row's K/V. The last call only writes dK's K/V
        (no head): on a full accept the commit point jumps to pos+K+1, and
        row pos+K would otherwise stay a hole the draft attends through."""
        t = tokens
        window = [tokens]
        for j in range(spec_k):
            d_logits, _ = draft_model.apply_decode(dcaches, t, pos + j)
            t = torch.argmax(d_logits, dim=-1)
            window.append(t)
        draft_model.apply_decode_features(dcaches, t, pos + spec_k)
        return torch.stack(window, dim=1)  # [B, K+1]

    @torch.inference_mode()
    def step(caches, dcaches, *rest):
        tokens, pos = rest[-2:]
        window = _draft_window(dcaches, tokens, pos)
        if paged:
            logits, _ = model.apply_decode_paged(caches, rest[0], window, pos)
        else:
            logits, _ = model.apply_decode_window(caches, window, pos)
        emitted, n_emit = _verify(window, logits, spec_k)
        return emitted, n_emit, logits

    return step
