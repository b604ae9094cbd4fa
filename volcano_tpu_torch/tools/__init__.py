"""The port's control-plane tools, one a reference tool of the same name
under ``tools/``: the chaos drills and their conductor, the soak, the
trace exporter, the race bench and the churn fuzz sweep.  Each runs as
``python -m volcano_tpu_torch.tools.<name>`` with the reference's flags
and output shapes."""
