"""Command-line tools of the port: ``single_predict`` (one image's top-5) and
``test_augment`` (an augment preview grid)."""
