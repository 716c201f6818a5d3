"""References that configurations name by path: a configuration file's
top-level ``"reference"``, such as ``portbench/references/<name>.py``
(``spec.Bench.reference``). Each is plain PyTorch or NumPy with the
interface that ``portbench/reference.py``'s docstring sets out, imports
nothing of the program, and may import ``portbench.reference`` to reuse
its Threefry copies, MLP, Adam and splits. A configuration that names
none is judged by ``portbench/reference.py``.
"""
