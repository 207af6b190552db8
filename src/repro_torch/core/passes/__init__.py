# Pass modules are imported individually (e.g. `from .passes import
# order_opt`); kernel_map/partition/schedule are added by the compiler.
