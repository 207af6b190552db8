"""Model families: how the port's ``gnn_builders`` express each model, and the
work (operations and bytes) one request needs, counted from the
configuration's widths and the graph's sizes alone."""
