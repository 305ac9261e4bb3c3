"""Architecture numbers of one configuration file as plain attributes.

The ``model`` block of a ``portbench/configs/*.json`` file holds SAM 2's
published settings under the names of its yaml and of the port's config
(``trunk``, ``neck``, ``memory_attention``, ``memory_encoder`` and the
top-level flags). :func:`arch` turns it into nested namespaces with the few
derived sizes that the plain reference and the analytic counts need. Nothing
here imports the program.
"""

from __future__ import annotations

from types import SimpleNamespace


def _ns(d):
    if isinstance(d, dict):
        return SimpleNamespace(**{k: _ns(v) for k, v in d.items()})
    if isinstance(d, list):
        return tuple(_ns(v) for v in d)
    return d


def block_schedule(trunk):
    """Per-block (dim, dim_out, num_heads, window_size, q_stride) of the Hiera
    trunk, as the upstream constructor loop builds it (``hieradet.py``): the
    window size follows the stage of the block's input, the width and heads
    grow at the first block of each later stage, and the first block of
    stages 2 to ``q_pool + 1`` pools its queries."""
    stage_ends = [sum(trunk.stages[: i + 1]) - 1 for i in range(len(trunk.stages))]
    q_pool_blocks = [x + 1 for x in stage_ends[:-1]][: trunk.q_pool]
    embed_dim, num_heads, cur_stage = trunk.embed_dim, trunk.num_heads, 1
    out = []
    for i in range(sum(trunk.stages)):
        dim_out = embed_dim
        window_size = trunk.window_spec[cur_stage - 1]
        if i in trunk.global_att_blocks:
            window_size = 0
        if i - 1 in stage_ends:
            dim_out = int(embed_dim * trunk.dim_mul)
            num_heads = int(num_heads * trunk.head_mul)
            cur_stage += 1
        out.append(dict(dim=embed_dim, dim_out=dim_out, num_heads=num_heads,
                        window_size=window_size,
                        q_stride=tuple(trunk.q_stride) if i in q_pool_blocks else None))
        embed_dim = dim_out
    return out


def arch(model: dict) -> SimpleNamespace:
    """Namespace of the ``model`` block, with ``hidden_dim``, ``mem_dim``,
    ``sam_image_embedding_size``, the trunk's ``stage_ends`` and
    ``block_schedule()``, as the reference and the analytic counts read
    them."""
    a = _ns(model)
    t = a.trunk
    t.stage_ends = tuple(sum(t.stages[: i + 1]) - 1 for i in range(len(t.stages)))
    schedule = block_schedule(t)
    t.block_schedule = lambda: [dict(s) for s in schedule]
    a.hidden_dim = a.memory_attention.d_model
    a.mem_dim = a.memory_encoder.out_dim
    a.sam_image_embedding_size = a.image_size // a.backbone_stride
    return a
