"""What the drivers and metric readers of one kind of configuration
share, and no other kind needs: ``wsi_*`` for the whole-slide-image
cells, ``serve`` for the language-model serving cells. The harness
(``run.py``, ``benchkit/``) reaches none of it."""
