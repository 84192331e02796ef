"""The plain reference that decides ``correct``: ``fz_ref`` (the FZ pipeline in
plain PyTorch, frozen) and ``check`` (the comparison and its limits). It
imports torch alone."""
