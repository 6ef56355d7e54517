"""``Rejuvenate``: MH with a custom proposal, without the accept step, as
an SMCP3 move (counterpart of
``genjax_tpu/inference/requests/rejuvenate.py``): propose, edit by
``Update``, and score the backward proposal; the edit weight is
``w_update + bwd_proposal_score − fwd_proposal_score``.
"""

from __future__ import annotations

from typing import Any

from genjax_torch.core import random
from genjax_torch.core.pytree import Pytree
from genjax_torch.gfi.concepts import Argdiffs, EditRequest
from genjax_torch.gfi.gfn import GenerativeFunction, Trace
from genjax_torch.gfi.requests import Update

__all__ = ["Rejuvenate"]


@Pytree.dataclass
class Rejuvenate(EditRequest):
    """``proposal``: a gen fn taking ``(old_choices, *proposal_args)``
    whose choices address a subset of the model's; the backward proposal
    is the same family at the discarded choices. Under a batch its
    tensor arguments lead with the batch, as every argument does."""

    proposal: GenerativeFunction[Any]
    proposal_args: tuple = Pytree.field(default=())

    def edit(self, key, tr: Trace[Any], argdiffs: Argdiffs):
        key, sub_key = random.split(key).unbind(-2)
        old_choices = tr.get_choices()
        fwd_tr = self.proposal.simulate(
            sub_key, (old_choices, *self.proposal_args))
        new_tr, w, retdiff, bwd = Update(fwd_tr.get_choices()).edit(
            key, tr, argdiffs)
        assert isinstance(bwd, Update)
        bwd_score, _ = self.proposal.assess(
            bwd.constraint, (new_tr.get_choices(), *self.proposal_args),
            batch=tr.batch_shape())
        final_w = w + bwd_score - fwd_tr.get_score()
        return new_tr, final_w, retdiff, Rejuvenate(self.proposal,
                                                    self.proposal_args)
