"""Text decoder model of the torch port: state, params, layers, forward."""
