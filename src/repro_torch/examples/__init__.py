"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_shared_corpus``, ``long_context_decode``, and
``train_tiny``, which trains). Each runs on the card; ``--device cpu``
takes the kernels' plain versions."""
