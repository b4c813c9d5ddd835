from .ode import odeint_fixed, FIXED_STEP_METHODS  # noqa: F401
