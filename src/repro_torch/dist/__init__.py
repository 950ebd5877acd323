"""The device plane's pod axis on ``torch.distributed`` (the counterpart of
``repro.dist``): the gradient exchange (``collectives``), the reference's
leaf layout for it (``grouping``) and the partitioning rule (``sharding``)."""
