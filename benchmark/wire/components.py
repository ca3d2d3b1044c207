"""The reference's wire form: every RNS component handed to the send
callback as it is produced (seal_embedded.c:180-204).

Per prime of the chain's walk, per message of the batch, c0 then c1,
each one chunk of 4n bytes: the n coefficients as little-endian u32
(seal_embedded.c:196-203).  A limb is 2B chunks; a call sends L limbs.

A form module gives the harness three things:

* ``KWARGS``: what the form asks of ``se_encrypt_streaming`` besides
  ``send``;
* ``limb_chunks(batch)``: the callback's chunks that make one limb;
* ``read(chunks, params, batch)``: each message as the form carries it
  (here its (c0, c1) as uint32 (L, n)), and the count of chunks that are
  missing, extra, out of order or of the wrong length.  The window calls
  it after every call, so it reads a message only when asked for it.

and may give three more (wire/seed.py gives all three):

* ``RETURNS``: the halves each limb dict the call returns carries, as
  (B, n) uint32 arrays; default ("c0", "c1").  A read message's leading
  arrays are these halves in this order, and only they are compared with
  the limbs returned; a limb lacking one is a walk error of its call;
* ``KINDS``: the encrypt types the form can carry; default ("sym",
  "asym").  A traffic of another type is refused before set-up;
* ``complete(got, params)``: one kept message as read turned into its
  (c0, c1) uint32 (L, n), such as c1 drawn again from a seed sent in its
  place.  The harness calls it after the window, once the program's
  state is freed, never in a timed or traced segment; its time counts in
  ``check_s``.  Without it a read message is its (c0, c1).
"""

from __future__ import annotations

import numpy as np

KWARGS: dict = {}
COEFF = np.dtype("<u4")      # uint32 on the little-endian hosts it runs on


def limb_chunks(batch: int) -> int:
    return 2 * batch


class Messages:
    """Message b's (c0, c1), uint32 (L, n), read from the chunks of one
    call on demand; a message with a chunk missing or of the wrong length
    reads as two empty arrays, so each of its coefficients counts as
    unequal to the reference."""

    def __init__(self, chunks, params, batch: int):
        self.chunks = chunks
        self.limbs = params.nprimes
        self.batch = batch
        self.size = params.degree * COEFF.itemsize

    def __len__(self) -> int:
        return self.batch

    def __getitem__(self, b: int) -> tuple:
        per = limb_chunks(self.batch)
        at = [[j * per + 2 * b + part for j in range(self.limbs)]
              for part in (0, 1)]
        if any(i >= len(self.chunks) or len(self.chunks[i]) != self.size
               for part in at for i in part):
            return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
        return tuple(np.stack([np.frombuffer(self.chunks[i], COEFF)
                               for i in part]) for part in at)


def read(chunks, params, batch: int) -> tuple:
    """(Messages of the call, bad): bad counts the chunks missing or extra
    against L limbs of 2B chunks, and those not 4n bytes long.  Their
    order carries no mark in this form: a chunk out of place shows where
    its bytes are compared (harness.Cell.window, check.py)."""
    size = params.degree * COEFF.itemsize
    want = params.nprimes * limb_chunks(batch)
    bad = abs(len(chunks) - want)
    bad += len(chunks) - list(map(len, chunks)).count(size)
    return Messages(chunks, params, batch), bad
