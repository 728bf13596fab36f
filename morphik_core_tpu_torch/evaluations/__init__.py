"""The evaluation harnesses of `evaluations/`, on the port: retrieval
metrics, the LLM judge, the RAG evaluator, the HotpotQA adapter, the int8
fidelity gate, the ColPali perturbation ladder and the offline RAG run.
Each prints its original's JSON report."""
