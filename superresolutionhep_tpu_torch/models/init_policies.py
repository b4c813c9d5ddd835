"""Weight-initialisation policies applied to a model ``state_dict`` (the
stage-1 FlowModel's or the stage-2 SAPF's).

Counterpart of the JAX package's ``models/init_policies.py`` (the
reference's config-keyed init policies):

  * ``all_linear: xavier_uniform`` — realised at construction time (every
    ``Linear`` is Xavier-uniform with zero bias), nothing to do here;
  * ``layer_emb_table: normal`` — embedding table ~ N(0, 0.02);
  * ``time_step_embedder: normal`` — the two timestep-MLP weights ~ N(0, 0.02);
  * ``ln_modulation: zero`` — zero every adaLN modulation Linear (weight and
    bias), the final ``v_t_adaLN_modulation`` included: every DiT block is
    then an identity at step 0;
  * ``v_t_pred_linear: zero`` — zero the last Linear of the v_t head.

Keys are the port's module names (``state_dict()``, no ``net.`` prefix).
Normal draws come from an explicit ``torch.Generator``; they are not the JAX
package's numbers (another generator), only the same distribution.
"""

from __future__ import annotations

from typing import Dict

import torch


def _final_linear_prefix(sd: Dict[str, torch.Tensor], head: str) -> str:
    """``{head}.net.{i}`` of the highest Sequential slot holding a weight."""
    slots = [int(k.split(".")[2]) for k in sd if k.startswith(f"{head}.net.") and k.endswith(".weight")]
    return f"{head}.net.{max(slots)}."


def apply_init_policies(state_dict: Dict[str, torch.Tensor], init_cfg: dict,
                        generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Return a new state dict with the configured policies applied."""
    sd = {k: v.clone() for k, v in state_dict.items()}

    def normal_like(v):
        return 0.02 * torch.randn(v.shape, generator=generator, dtype=torch.float32, device="cpu").to(v)

    if init_cfg.get("ln_modulation") == "zero":
        for k in sd:
            if any("adaLN_modulation" in part for part in k.split(".")):
                sd[k] = torch.zeros_like(sd[k])

    if init_cfg.get("layer_emb_table") == "normal":
        # by name, as the JAX package: the PF encoder's table is called
        # layer_emb_net, and the policy leaves it as it is
        for k in sorted(sd):
            if "layer_emb_table" in k.split(".") and k.endswith(".weight"):
                sd[k] = normal_like(sd[k])

    if init_cfg.get("time_step_embedder") == "normal":
        for k in sorted(sd):
            if k.startswith("time_step_embedder.") and k.endswith(".weight"):
                sd[k] = normal_like(sd[k])

    if init_cfg.get("v_t_pred_linear") == "zero":
        prefix = _final_linear_prefix(sd, "v_t_pred_net")
        for k in sd:
            if k.startswith(prefix):
                sd[k] = torch.zeros_like(sd[k])

    return sd
