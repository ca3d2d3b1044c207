"""ternary_redo_rows (rows/M): the asym rows encrypted again because the
ternary draw's bounded refill queue fell short (the program's counter,
``seal_embedded_tpu_torch.ckks.asym.redo_counts()``), per million asym
messages the API encrypted, both since the process began (set-up, the
warm-up, the window and the traced segments).  The C loop redraws
without bound; reckoned from its byte law a 96-byte block needs more
than 8 refills with p = 1.53e-7, about 26 rows a million messages at
n = 16384.  None where the program keeps no such counter or encrypted no
asym message."""


def read(obs):
    from seal_embedded_tpu_torch.ckks import asym
    counts = getattr(asym, "redo_counts", None)
    if counts is None:
        return None
    got = counts()
    if not got.get("messages"):
        return None
    return 1e6 * got["rows"] / got["messages"]
