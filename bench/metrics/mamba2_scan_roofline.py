"""Percent of its roofline that ``mamba2_scan_kernel`` reached in the
prefills of the traced window: each launch is one Mamba2 layer's
inter-chunk recurrence over a batch, ``C = prompt_len / ssd_chunk``
chunks of ``B x H`` rows of ``P x N`` float32 elements: decay (C, BH)
and the increments (C, BH, PN) read once, the states entering each
chunk (C, BH, PN) and the final state (BH, PN) written once, against
2 float32 operations an element and chunk (the bytes bound it)."""

from benchkit.peaks import roofline_share


def read(run):
    own = run.own
    m = own.model
    d_inner = int(m["ssm_expand"]) * int(m["d_model"])
    rows = own.batch_size * d_inner // int(m["ssm_head_dim"])
    elems = int(m["ssm_head_dim"]) * int(m["ssm_state"])
    chunks = own.prompt_len // own.ssd_chunk
    nbytes = 4.0 * (chunks * rows + 2 * chunks * rows * elems + rows * elems)
    return roofline_share(run, "mamba2_scan_kernel", nbytes, 2.0 * chunks * rows * elems)
