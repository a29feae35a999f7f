"""HyenaOperator (mirrors `hyena_dna_tpu/models/hyena.py`).

Order 2 with one head and one block (every shipped config) takes the JAX
package's fused-front route (`_try_pallas_front`):

  u (B, L, d) --kernel A: in_proj + causal k=3 conv + first gate-->
  vx = v * x1, x0 (B, d, L) --dropout on vx--> --filter bank k (d, L)-->
  y = (causal_conv(vx, k) + vx * bias) * x0 --kernel B-->
  (B, L, d) --activation, out_proj--> (B, L, d)

Activations run in `dtype`: in bfloat16, u enters kernel A in bf16 and vx,
x0 come out in bf16 (the Pallas kernel's `out_dtype = u.dtype`), the gated
conv's result is cast back to bf16 and `out_proj` is a bf16 product; the
parameters stay float32.

On a CUDA tensor kernels A and B run forward and kernels A' and C backward
(`ops/fused_front.py`, `ops/fused_fftconv.py`, through their
`autograd.Function`s); the second gate is a plain multiply that autograd
differentiates, as in the JAX composite route. With `gated_conv` set to a
mode of `ops.fftconv.GATED_MODES` ("specv", "spec", "retransform"), the
post-gate rides the conv instead: kernel E forward and kernel E' backward
on that mode's route, where `gated_plan` covers the shape (as
`HYENA_GATED_CONV=1` and `HYENA_GATED_MODE` do for the JAX package; off by
default there and here). On a CPU tensor the same calls run their plain
versions. Kernel A takes any L (the Pallas front
needed L % 32 == 0). Whatever `dtype`, from L = 2^15 the conv I/O (signal,
gate, filter bank) is bfloat16 as on the TPU (`CONV_IO_BF16_MIN_L`), and
below it float32; the transforms run in float32. When L exceeds
`l_max` only the filter is cut to `l_max` (a causal conv with a shorter
filter), as in the JAX package.

With `front4` (the layer-config key `front4`; the JAX `HYENA_FRONT4=1`,
off by default there and here) the layer takes the 4-D conv-layout route
of the JAX `_try_front4` where it engages: order 2, the whole sequence
filtered (L <= l_max), an outer plan (n1, r, m) for the conv's fft size
(`ops/fused_fftconv.py::plan_outer`: fft 2^17-2^18 at odd B, 2^19-2^21 at
any B), a length tile in (512, 256, 128) that fits the plan
(`ops/fused_front.py::check_plan4`), L <= lp and rows_pad % 8 == 0. There
kernel A4 writes vx and x0 as (B, d, rows_pad, m), the zero-padded flat
(B, d, lp) with lp = rows_pad * m = n / 2; the filter bank is padded to lp
and laid out the same way; the conv runs on that layout
(`ops/fftconv.py::fftconv_outer_4d`, kernels B and C), the gate multiplies
the padded tensors, and the result is flattened, cut to L and transposed.
Backward: kernel A4', kernel C. Elsewhere the flat route runs. The math is
the flat route's; the conv transforms and writes lp >= L times.

`inner_remat` (the JAX option that checkpoints the unfused front end,
in_proj and the short conv, on its own) checkpoints the general path's
front end; on the fused route it changes nothing, since kernel A' already
recomputes the projection and the short conv from u instead of saving
them, so outputs and gradients are the same bits with and without it.

For activation checkpointing (`ops/remat.py`) the conv output is tagged
(the ungated one of the composite route, and v4), and so is the filter
bank (the (d, L) bank, and k4 on the 4-D route), as the JAX package tags
them.

The general path (the JAX unfused routes, which take no fused front end
on any backend): `order > 2`, `num_heads`, `num_blocks`, `outer_mixing`,
`post_order_ffn`, or a short filter other than k = 3. The front end is
`in_proj` and `ops/short_conv.py` in `dtype` (checkpointed on its own under
`inner_remat`, the JAX `_front_3d`), and the channel axis splits into
order + 1 equal chunks x_0 .. x_{o-1}, v. Then
  * one head and one block (`_tail_3d`): for each x_i from x_{o-1} down to
    x_1, v = dropout(v * x_i), then v = conv(v, k_i) + v * D_i, the last
    one gated by x_0 (`fftconv_gated`: the composite route, or kernels E
    and E' with `gated_conv` where their plan covers the shape);
  * otherwise (`_tail_generic`): the channels reshape to (heads, head_dim)
    and the length to (num_blocks, L / num_blocks); each step multiplies by
    x_i (with `outer_mixing`, the outer product summed over the x_i
    channel axis), drops out and convolves through `HyenaFilter.forward`
    on the flattened (B*H*Z, hd, l) layout; with `post_order_ffn` the
    heads mix through `ord_proj_w[i]`, summed over its first head index;
    y = v * x_0, back to (B, L, d).
The filter bank (L, hd * (order - 1)) splits with the order index fastest,
and so does its bias, as in the JAX module; the bank is float32 and every
conv runs in float32 through `ops/fftconv.py::fftconv_chunked` (kernels B
and C on the card), so a step of order o runs kernel B o - 1 times forward
and kernel C as often backward. `inner_factor` other than 1 raises, as in
the JAX package (the reference's in_proj and short filter disagree on the
width). The skip term uses the filter's `bias` on the 3-D routes whatever
`use_bias` says, as the JAX `_tail_3d` does; `HyenaFilter.forward` (the
general route) honours it.

Sequence parallelism (`mesh`, a `parallel.sharding.Mesh` whose seq axis is
above 1; JAX `hyena.py:157-191`): each rank holds its contiguous L / S
columns of u, and the operator takes the JAX sequence-sharded route
whatever its order: `in_proj` and the short conv in `dtype`, the short
conv with the left neighbour's halo (`ops/distributed.py::seq_short_conv`),
then `_tail_3d` with every conv through the channel-pencil conv
(`seq_fftconv`: kernel B forward, kernel C backward on each rank's
(B, d / S, L) pencil, in the conv I/O dtype of the global length), and the
last gate as a multiply. No fused front end (kernel A) and no gate-fused
conv, as in the JAX package; one head and one block only. The filter bank
is built at the global length L = S * (local length), which is also what
`l_max` is held against.

Tensor parallelism (a `mesh` whose model axis M divides d_model;
`parallel/sharding.py`): the rank holds its d / M channels of each of the
order + 1 chunks [x_0 .. x_{o-1} | v], as in_proj's columns (its weight's
rows) and bias, the short filter's channels, and the matching rows of the
filter bank and of the skip D; out_proj is row-parallel (its weight's
columns of those channels). u enters through `copy_to_model` (its gradient,
the ranks' partial sums, is all-reduced); on the fused route kernel A
projects the whole u onto the rank's 3 d / M columns (W (d, 3 d / M)) and
kernel A' gives the rank's partial du; kernels B and C (or E and E') run
on the rank's (B, d / M, L) channels; the plain 3-D route at order > 2 and
the sequence-sharded route split the same way. The output projection's
partial sums go through `reduce_from_model`, then its bias is added once.
The filter MLP is replicated, as the JAX rules leave it ("filter MLP is
tiny"): each rank builds the whole bank and takes its rows, so its filter
gradients are the rank's share of a sum (`tp_partial`). Dropout draws the
whole channel mask and takes the rank's rows (`models/nn.py::dropout_slice`).
With `front4` the rank's kernel A4 writes its (B, d / M, rows_pad, m)
channels (W (d, 3 d / M)), kernel A4' gives its partial du, and the 4-D
conv runs on its rows of the padded bank. A width that does not divide by
M runs whole on each rank.

The general path under a model axis (the JAX rules split in_proj's columns,
the short filter and out_proj's rows whatever the options;
`_tail_generic` lays the columns out head-major, (heads, (order + 1)
head_dim)):
  * where M divides `num_heads` the rank holds heads h0 .. h0 + H / M
    whole: contiguous columns of in_proj and the short filter, contiguous
    input rows of out_proj. Blocks fold L and outer mixing stays inside a
    head, so neither needs a collective; the post-order FFN mixes heads,
    so v is gathered over the model group before each of its products
    (`ops/distributed.py::gather_along`, the gradient reduce-scattered)
    and the rank computes its own output heads;
  * else, where M divides head_dim (one head with blocks, say), the rank
    holds its head_dim / M channels of each chunk of each head, as the 3-D
    path splits d. The post-order FFN mixes heads channel by channel, so it
    needs nothing; outer mixing sums over every channel of x_i, and its
    dropout falls on the outer product before that sum, so x_i is gathered
    over the model group and the rank forms its v channels' products;
  * else the operator runs whole on each rank.
The filter bank (order - 1, head_dim, L) is shared by every head: each
rank builds it whole and takes the rows it convolves, so its gradient, and
`ord_proj_w`'s (each rank forms its output heads or channels), is the
rank's share of a sum (`tp_partial`). Dropout masks are drawn whole and
sliced on the split dimension.

Parameter names are the reference torch names: `in_proj`, `out_proj`,
`short_filter` (a depthwise Conv1d weight ((o+1)d, 1, k)), `filter_fn`,
and `ord_proj_w` (order, heads, heads) with `post_order_ffn`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hyena_dna_tpu_torch.models.filters import HyenaFilter
from hyena_dna_tpu_torch.models.nn import activation_fn, dropout_slice, row_parallel
from hyena_dna_tpu_torch.ops import remat
from hyena_dna_tpu_torch.ops.distributed import (copy_to_model, gather_along, seq_fftconv,
                                                  seq_short_conv)
from hyena_dna_tpu_torch.ops.fftconv import (GATED_MODES, fftconv_gated, fftconv_outer_4d,
                                             fftconv_tagged, next_fast_fft_size)
from hyena_dna_tpu_torch.ops.fused_fftconv import plan_outer
from hyena_dna_tpu_torch.ops.fused_front import fused_proj_conv_gate, fused_proj_conv_gate4
from hyena_dna_tpu_torch.parallel.sharding import model_axis

CONV_IO_BF16_MIN_L = 1 << 15
FRONT4_TILES = (512, 256, 128)  # the JAX route's length tiles, in order of preference


def front4_tile(length: int, lp: int, m: int):
    """The 4-D route's length tile for L = `length` on rows of m times
    padded to lp (the first of `FRONT4_TILES` that `check_plan4` accepts),
    or None."""
    return next((t for t in FRONT4_TILES if length % t == 0 and t % m == 0
                 and lp % t == 0 and 8 % (t // m) == 0), None)


class HyenaOperator(nn.Module):
    def __init__(self, d_model: int, l_max: int, order: int = 2,
                 filter_order: int = 64, short_filter_order: int = 3,
                 activation: str = "id", filter_cfg: dict | None = None,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 gated_conv: str | None = None, front4: bool = False,
                 inner_remat: bool = False, num_heads: int = 1, num_blocks: int = 1,
                 inner_factor: int = 1, outer_mixing: bool = False,
                 post_order_ffn: bool = False, mesh=None):
        super().__init__()
        if order < 2:
            raise ValueError(f"order must be at least 2, got {order}")
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} is not a multiple of num_heads={num_heads}")
        if l_max % num_blocks:
            raise ValueError(f"l_max={l_max} is not a multiple of num_blocks={num_blocks}")
        if inner_factor != 1:
            raise NotImplementedError(
                "inner_factor > 1 is inconsistent in the reference (in_proj/short_filter "
                "width mismatch) and unsupported, as in the JAX package")
        self.inner_remat = inner_remat
        self.dtype = dtype
        self.front4 = front4
        if gated_conv not in (None,) + GATED_MODES:
            raise ValueError(f"gated_conv={gated_conv!r} is not None or one of {GATED_MODES}")
        self.gated_conv = gated_conv
        self.d_model = d_model
        self.l_max = l_max
        self.order = order
        self.num_heads = num_heads
        self.num_blocks = num_blocks
        self.outer_mixing = outer_mixing
        self.post_order_ffn = post_order_ffn
        self.head_dim = d_model // num_heads
        self.plain_3d = num_heads == 1 and num_blocks == 1 and not outer_mixing \
            and not post_order_ffn
        self.mesh = mesh if mesh is not None and mesh.seq > 1 else None
        if self.mesh is not None and not self.plain_3d:
            raise NotImplementedError("sequence-parallel Hyena takes one head and one block "
                                      "(the DNA configs), as in the JAX package")
        # the model-axis split: "chunks" (the 3-D routes: each rank its d / M
        # channels of each chunk), "heads" or "channels" (the general path)
        if self.plain_3d:
            self.tp, self.split = model_axis(mesh, d_model), "chunks"
        elif model_axis(mesh, num_heads) is not None:
            self.tp, self.split = mesh, "heads"
        else:
            self.tp, self.split = model_axis(mesh, self.head_dim), "channels"
        # the fused front (kernel A) fuses order 2 and a k = 3 short conv
        self.fused = (self.plain_3d and order == 2 and short_filter_order == 3
                      and self.mesh is None)
        # this rank's channels of each chunk: all of them without a model axis
        m = self.tp.model if self.tp is not None else 1
        self.d_local = d_model // m
        i = self.tp.model_index if self.tp is not None else 0
        self.rows = slice(i * self.d_local, (i + 1) * self.d_local)
        # the general path's local heads and head channels, and where they start
        heads = self.split == "heads"
        self.local_heads = num_heads // m if heads else num_heads
        self.local_head_dim = self.head_dim if heads else self.head_dim // m
        self.head0 = i * self.local_heads if heads else 0
        self.channel0 = 0 if heads else i * self.local_head_dim
        width = (order + 1) * self.d_local
        self.in_proj = nn.Linear(d_model, width)
        self.out_proj = nn.Linear(self.d_local, d_model)
        self.short_filter = nn.Conv1d(width, width, short_filter_order, groups=width,
                                      padding=short_filter_order - 1)
        self.filter_fn = HyenaFilter(self.head_dim * (order - 1), order=filter_order,
                                     seq_len=l_max, **(filter_cfg or {}))
        if post_order_ffn:  # drawn by `init_weights`
            self.ord_proj_w = nn.Parameter(torch.empty(order, num_heads, num_heads))
        self.act = activation_fn(activation)
        self.dropout = dropout
        if self.tp is not None:  # `parallel/sharding.py::tp_layout`
            # in_proj's columns: [x_0 .. x_{o-1} | v] (chunks), head-major
            # ((heads, (o + 1) head_dim): the rank's heads are contiguous), or
            # each head's (o + 1) chunks of head_dim (channels)
            n_in = {"chunks": order + 1, "heads": 1, "channels": num_heads * (order + 1)}
            n_out = {"chunks": 1, "heads": 1, "channels": num_heads}
            names = ("in_proj.weight", "in_proj.bias", "short_filter.weight", "short_filter.bias")
            self.tp_rules = {name: (0, n_in[self.split]) for name in names}
            self.tp_rules["out_proj.weight"] = (1, n_out[self.split])
            self.tp_partial = ("filter_fn",) + ("ord_proj_w",) * post_order_ffn

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None, n_layer: int = 1) -> None:
        """The JAX module's init, the one place of this rule (the LM calls
        it for each operator): `ord_proj_w` N(0, std 1/sqrt(head_dim)), then
        in module order Linear weights N(0, 0.02) (out_proj
        0.02 / sqrt(2 n_layer)) with zero biases, the short filter
        U(-1/sqrt(k), 1/sqrt(k)), the filter's skip bias N(0, 1)."""
        if self.post_order_ffn:
            self.ord_proj_w.normal_(0.0, 1.0 / math.sqrt(self.head_dim), generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = 0.02 / math.sqrt(2 * n_layer) if mod is self.out_proj else 0.02
                mod.weight.normal_(0.0, std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                bound = 1.0 / math.sqrt(mod.kernel_size[0])
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif mod is self.filter_fn:
                mod.bias.normal_(0.0, 1.0, generator=generator)

    def front4_plan(self, batch: int, length: int):
        """(n1, r, m, rows_pad, tile_l) where the 4-D route engages for a
        (batch, length) input (JAX `_try_front4`), else None."""
        if not self.front4 or not self.fused or length > self.l_max:
            return None
        # the plan of the conv this rank runs: its d_local channels (d / M under
        # a model axis); the outer table, like the JAX one, does not read it
        spec = plan_outer(next_fast_fft_size(2 * length), self.d_local, length, batch)
        if spec is None:
            return None
        n1, r, m = spec
        rows_pad = (n1 // 2) * r
        lp = rows_pad * m
        tile_l = front4_tile(length, lp, m)
        if tile_l is None or length > lp or rows_pad % 8:
            return None
        return n1, r, m, rows_pad, tile_l

    def _filter_bank(self, length: int, dtype: torch.dtype, rows: int = 0, m: int = 0):
        """The (d, L) filter bank, or with (rows, m) its (d, rows, m) 4-D
        form, zero past L; tagged for checkpointing (`ops/remat.py`)."""
        def build():
            k = self.filter_fn.filter(length, out_dtype=dtype)[0]  # (L, d)
            if not rows:
                return k.t().contiguous()
            kp = F.pad(k, (0, 0, 0, rows * m - length))  # the time axis, as JAX pads it
            return kp.reshape(rows, m, -1).permute(2, 0, 1).contiguous()

        params = (p for name, p in self.filter_fn.named_parameters() if name != "bias")
        return remat.filter_bank(build, params)

    def forward(self, u: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """u: (B, L, d) in `dtype` -> (B, L, d) in `dtype`; `generator`
        draws the dropout mask in training."""
        b, length = u.shape[:2]
        if self.mesh is not None:  # this rank's columns of the global length
            length *= self.mesh.seq
        l_filter = min(length, self.l_max)
        u = copy_to_model(u, self.tp)
        if not self.fused:
            uc = self._front(u)
            if self.plain_3d:
                y = self._tail_3d(uc, l_filter, generator)
            else:
                y = self._tail_generic(uc, l_filter, generator)
            return row_parallel(self.act(y), self.out_proj, self.dtype, self.tp)
        w = self.in_proj.weight.float().t().contiguous()          # (d, 3 d_local)
        bp = self.in_proj.bias.float().contiguous()
        wc = self.short_filter.weight[:, 0, :].float().t().contiguous()  # (3, 3d)
        bc = self.short_filter.bias.float().contiguous()
        conv_dt = torch.bfloat16 if l_filter >= CONV_IO_BF16_MIN_L else torch.float32
        D = self.filter_fn.bias.float()[self.rows].contiguous()
        plan = self.front4_plan(b, length)
        if plan is not None:
            n1, r, m, rows_pad, tile_l = plan
            vx4, x04 = fused_proj_conv_gate4(u.contiguous(), w, bp, wc, bc, rows_pad, m, tile_l)
            vx4 = self._dropout(vx4, generator)
            k4 = self._filter_bank(l_filter, conv_dt, rows_pad, m)[self.rows]
            v4 = fftconv_outer_4d(vx4.to(conv_dt), k4, D, n1, r, m)
            y4 = (v4 * x04.to(conv_dt)).to(u.dtype)
            # flatten and cut before the transpose (JAX transposes first): the
            # same values, and the gate's cotangent comes back channel-major
            # through one copy instead of as a 4-D strided view
            y = y4.reshape(b, -1, rows_pad * m)[..., :length].transpose(1, 2)
            return row_parallel(self.act(y), self.out_proj, self.dtype, self.tp)
        vx, x0 = fused_proj_conv_gate(u.contiguous(), w, bp, wc, bc)
        vx = self._dropout(vx, generator)
        k = self._filter_bank(l_filter, conv_dt)[self.rows]
        y = fftconv_gated(vx.to(conv_dt), x0.to(conv_dt), k, D, self.gated_conv).to(u.dtype)
        return row_parallel(self.act(y.transpose(1, 2)), self.out_proj, self.dtype, self.tp)

    def _dropout(self, x: torch.Tensor, generator) -> torch.Tensor:
        """Dropout of the rank's channels (dim 1) of the whole (B, d, ...)
        tensor's mask."""
        return dropout_slice(x, self.dropout, self.training, generator,
                             (1, self.d_model, self.rows.start or 0))

    def _head_dropout(self, x: torch.Tensor, generator, channel_dim: int) -> torch.Tensor:
        """Dropout on the general path's (B, heads, ...) tensors: the whole
        mask sliced on the rank's heads (dim 1) or on its channels of a head
        (`channel_dim`)."""
        cut = ((1, self.num_heads, self.head0) if self.split == "heads"
               else (channel_dim, self.head_dim, self.channel0))
        return dropout_slice(x, self.dropout, self.training, generator, cut)

    def _front(self, u: torch.Tensor) -> torch.Tensor:
        """in_proj -> (B, (o+1)d, L) -> causal depthwise short conv, in
        `dtype` (JAX `_front_3d`; under a seq axis with the halo); its own
        checkpoint under `inner_remat`."""
        def front(u, w, bp, wc, bc):
            proj = F.linear(u.to(self.dtype), w.to(self.dtype), bp.to(self.dtype))
            return seq_short_conv(proj.transpose(1, 2), wc.to(self.dtype), bc.to(self.dtype),
                                  self.mesh)

        args = (u, self.in_proj.weight, self.in_proj.bias, self.short_filter.weight[:, 0, :],
                self.short_filter.bias)
        if self.inner_remat and torch.is_grad_enabled():
            return checkpoint(front, *args, use_reentrant=False)
        return front(*args)

    def _general_bank(self, l_filter: int, width: int, dtype: torch.dtype = torch.float32):
        """The bank in `dtype` as (o-1, width, L) and the bias as (o-1,
        width): the filter's channels split (width, o-1) with the order
        index fastest (the reference's "c l (v o) -> c o v l")."""
        o = self.order
        k = self._filter_bank(l_filter, dtype)  # ((o-1) width, L)
        k = k.reshape(width, o - 1, l_filter).transpose(0, 1)
        bias = self.filter_fn.bias.reshape(width, o - 1).t()
        return k, bias

    def _tail_3d(self, uc: torch.Tensor, l_filter: int, generator) -> torch.Tensor:
        """One head, one block (JAX `_tail_3d`): (B, (o+1)d, L) -> (B, L, d);
        under a seq axis every conv is `seq_fftconv` on v in `dtype`, in the
        conv I/O dtype of the global length, and the last gate a multiply
        (JAX `distributed=True`)."""
        *x, v = uc.split(self.d_local, dim=1)
        if self.mesh is not None:
            conv_dt = torch.bfloat16 if l_filter >= CONV_IO_BF16_MIN_L else torch.float32
            k, bias = self._general_bank(l_filter, self.d_model, conv_dt)
            k, bias = k[:, self.rows], bias[:, self.rows]
            for i, x_i in enumerate(reversed(x[1:])):
                v = self._dropout(v * x_i, generator)
                v = seq_fftconv(v, k[i].contiguous(), bias[i].float().contiguous(), self.mesh)
            return (v * x[0]).transpose(1, 2)
        k, bias = self._general_bank(l_filter, self.d_model)
        k, bias = k[:, self.rows], bias[:, self.rows]
        last = self.order - 2
        for i, x_i in enumerate(reversed(x[1:])):
            v = self._dropout(v * x_i, generator)
            vf, k_i, d_i = v.float().contiguous(), k[i].contiguous(), bias[i].float().contiguous()
            if i == last:
                v = fftconv_gated(vf, x[0].float().contiguous(), k_i, d_i,
                                  self.gated_conv).to(v.dtype)
            else:
                v = fftconv_tagged(vf, k_i, d_i).to(v.dtype)
        return v.transpose(1, 2)

    def _tail_generic(self, uc: torch.Tensor, l_filter: int, generator) -> torch.Tensor:
        """Heads, blocks, outer mixing, post-order FFN (JAX `_tail_generic`):
        (B, (o+1)d, L) -> (B, L, d); under a model axis the rank's heads or
        head channels (see the module docstring)."""
        b, _, l_seq = uc.shape
        z, o = self.num_blocks, self.order
        ho, hd = self.local_heads, self.local_head_dim
        uc = uc.reshape(b, ho, hd * (o + 1), z, l_seq // z)
        *x, v = uc.split(hd, dim=2)
        k, bias = self._general_bank(l_filter, self.head_dim)
        cols = slice(self.channel0, self.channel0 + hd)
        k, bias = k[:, cols], bias[:, cols]
        group = self.tp.model_group if self.tp is not None else None
        for i, x_i in enumerate(reversed(x[1:])):
            if self.outer_mixing:
                if group is not None and self.split == "channels":  # every channel of x_i
                    x_i = gather_along(x_i, group, 2)
                v = v[:, :, None] * x_i[:, :, :, None]
                v = self._head_dropout(v, generator, 3).sum(2)
            else:
                v = self._head_dropout(v * x_i, generator, 2)
            v = self.filter_fn(v, l_seq // z, k=k[i], bias=bias[i])
            if self.post_order_ffn:
                w = self.ord_proj_w[i]
                if group is not None and self.split == "heads":  # every head, the rank's out
                    v = gather_along(v, group, 1)
                    w = w[:, self.head0:self.head0 + ho]
                v = torch.einsum("ji,bjvzl->bivzl", w.to(v.dtype), v)
        y = v * x[0]
        return y.permute(0, 3, 4, 1, 2).reshape(b, l_seq, ho * hd)
