"""Model substrate of the port: parameter declarations, layer math, attention, the
dense decoder and the model API (``zoo.build``)."""
