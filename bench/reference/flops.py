"""Model FLOPs: the operations a step needs, from the configuration and the
shapes alone, whatever the program does to compute them.

- Every matmul weight costs 2 operations a token forward (the output head
  included, the embedding lookup excluded), 6 forward and backward.
- Attention's Q K^T and P V over the causal half: 4 * heads * head_dim
  operations a (query, key) pair with key <= query, forward.
- The SSD mixer's recurrence: the state update dt x B^T and the read-out
  C . h, 2 * P * N operations each a token and SSM head, forward; its
  depthwise conv 2 * kernel operations a channel and token.
- Recompute (remat) is not counted.  A prefill needs the head at each
  prompt's last position only.

``cfg`` is a configuration file's dict (``bench/configs``).
"""

from __future__ import annotations


def _mixer(cfg) -> str:
    return "ssm" if cfg.get("ssm_state", 0) and not cfg["num_heads"] else "attn"


def layer_matmul_params(cfg) -> int:
    """Matmul weights of one layer."""
    d = cfg["d_model"]
    n = 0
    if _mixer(cfg) == "attn":
        H, KH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        n += d * H * hd + 2 * d * KH * hd + H * hd * d
    else:
        din = cfg["ssm_expand"] * d
        nh = din // cfg["ssm_head_dim"]
        n += d * (2 * din + 2 * cfg["ssm_state"] + nh) + din * d
    if cfg.get("d_ff", 0):
        n += (3 if cfg.get("mlp_type", "swiglu") == "swiglu" else 2) \
            * d * cfg["d_ff"]
    return n


def head_params(cfg) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def mixer_flops(cfg, batch: int, seq: int) -> int:
    """Forward operations of every layer's sequence mixer outside its
    weights, for ``batch`` sequences of ``seq`` tokens."""
    L = cfg["num_layers"]
    if _mixer(cfg) == "attn":
        pairs = seq * (seq + 1) // 2
        return L * batch * 4 * cfg["num_heads"] * cfg["head_dim"] * pairs
    din = cfg["ssm_expand"] * cfg["d_model"]
    nh = din // cfg["ssm_head_dim"]
    per_token = (4 * nh * cfg["ssm_head_dim"] * cfg["ssm_state"]
                 + 2 * cfg["conv_kernel"] * din)
    return L * batch * seq * per_token


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """Forward and backward of one step over ``batch`` x ``seq`` tokens."""
    params = cfg["num_layers"] * layer_matmul_params(cfg) + head_params(cfg)
    return 6 * params * batch * seq + 3 * mixer_flops(cfg, batch, seq)


def prefill_flops(cfg, batch: int, seq: int) -> int:
    """The forward over ``batch`` prompts of ``seq`` tokens, with the head
    at each prompt's last position."""
    layers = cfg["num_layers"] * layer_matmul_params(cfg)
    return (2 * layers * batch * seq + 2 * head_params(cfg) * batch
            + mixer_flops(cfg, batch, seq))
