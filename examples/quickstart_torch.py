"""Quickstart on the PyTorch/CUDA port: the paper's Employee example.

The same walk-through as ``examples/quickstart.py``, through
``repro_torch`` (no JAX): a trusted DB owner outsources a relation as
Shamir secret-shares to c simulated clouds; an (authorized) user then
holds ONE QueryClient over the shares and runs oblivious count, selection,
pattern, range, aggregate and join queries WITHOUT the owner being online,
and without any cloud learning the data, the query, or the result. The
shares live on the GPU and every cloud step is a CUDA kernel launch.

  PYTHONPATH=src python examples/quickstart_torch.py               # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import (Aggregate, Count, Eq, Like, Padding,  # noqa: E402
                             QueryClient, Select)
from repro_torch.core import Codec, outsource  # noqa: E402

EMPLOYEE = [
    ["E101", "Adam", "Smith", "1000", "Sale"],
    ["E102", "John", "Taylor", "2000", "Design"],
    ["E103", "Eve", "Smith", "500", "Sale"],
    ["E104", "John", "Williams", "5000", "Sale"],
]


def main(device=None):
    codec = Codec(word_length=8)
    print("== DB owner: create & distribute secret-shares (one-time) ==")
    db = outsource(EMPLOYEE, column_names=["EmployeeId", "FirstName",
                                           "LastName", "Salary",
                                           "Department"],
                   codec=codec, n_shares=20, degree=1,
                   numeric_columns={3: 14}, seed=7, device=device)
    print(f"  {db.n_tuples} tuples x {db.n_attrs} attrs -> "
          f"{db.n_shares} clouds on {db.device}; every value shared with "
          f"an independent degree-{db.base_degree} polynomial\n")

    # one cloud's view of the two 'John's — different shares (no frequency
    # attack possible)
    v0 = db.relation.values[0, 1, 1, 0].cpu().numpy()  # John #1, 'J'
    v1 = db.relation.values[0, 3, 1, 0].cpu().numpy()  # John #2, 'J'
    print(f"  cloud 0's share of 'J' in tuple 2: {v0[:4]}...")
    print(f"  cloud 0's share of 'J' in tuple 4: {v1[:4]}...  (different!)\n")

    print("== User: one QueryClient, per-query streams derived "
          "automatically ==")
    client = QueryClient(db, seed=42, device=device)

    print("== COUNT (§3.1): how many employees named John? ==")
    res = client.count("FirstName", "John")
    print(f"  -> {res.count}   [{res.ledger}]\n")

    print("== SELECT (§3.2): WHERE FirstName='John', planner-chosen ==")
    plan = Select(Eq("FirstName", "John"))
    for est in client.explain(plan):
        print(f"  planner: {est.strategy:<10} ~{est.bits} bits, "
              f"{est.rounds} rounds")
    res = client.run(plan)
    print(f"  -> chose {res.strategy!r}; addresses {res.addresses}; "
          f"rows: {res.rows}  [rounds={res.ledger.rounds}]\n")

    print("== SELECT forced strategies (§3.2.1 / §3.2.2) ==")
    res = client.select("FirstName", "Eve", strategy="one_tuple")
    print(f"  one_tuple  -> {res.rows[0]}")
    res = client.select("Department", "Sale", strategy="tree")
    print(f"  tree       -> {res.count} rows in {res.ledger.rounds} "
          f"Q&A rounds")
    # fake-row padding hides the true result size from the clouds
    res = client.select("FirstName", "John", strategy="one_round",
                        padding=Padding.to_rows(4))
    print(f"  one_round  -> {len(res.rows)} real rows behind a 4-row "
          f"padded fetch\n")

    print("== PATTERN (LIKE): wildcard predicates on shares ==")
    res = client.run(Count(Like("FirstName", "Jo%")))
    print(f"  COUNT(FirstName LIKE 'Jo%')        -> {res.count}")
    res = client.run(Select(Like("LastName", "%ith%")))
    print(f"  SELECT WHERE LastName LIKE '%ith%' -> "
          f"{[r[1] + ' ' + r[2] for r in res.rows]}  "
          f"[rounds={res.ledger.rounds}]\n")

    print("== RANGE (§3.4): Salary in [1000, 2000] ==")
    # 14-bit SS-SUB grows the polynomial degree past our 20 clouds ->
    # apply the paper's degree-reduction (re-sharing) every 2 bits
    cnt = client.range_count("Salary", 1000, 2000, reduce_every=2)
    sel = client.range_select("Salary", 1000, 2000, reduce_every=2)
    print(f"  -> count {cnt.count}; rows {[r[0] for r in sel.rows]}\n")

    print("== AGGREGATE: verified AVG(Salary) WHERE FirstName='John' ==")
    plan = Aggregate("avg", "Salary", where=Eq("FirstName", "John"),
                     verify=True)
    est = client.explain([plan]).groups[0].estimate
    print(f"  planner: ~{est.bits} bits, {est.rounds} rounds "
          f"(verification included)")
    res = client.run(plan)
    print(f"  -> AVG = {res.value} over {res.count} matching rows, "
          f"verified  [rounds={res.ledger.rounds}]")
    lo = client.run(Aggregate("min", "Salary", reduce_every=2))
    print(f"  -> MIN(Salary) = {lo.value} via the ripple-comparator "
          f"tournament\n")

    print("== PK/FK JOIN (§3.3.1): X(A,B) |x| Y(B,C) ==")
    codec6 = Codec(word_length=6)
    X = [["a1", "b1"], ["a2", "b2"], ["a3", "b3"]]
    Y = [["b1", "c1"], ["b2", "c2"], ["b2", "c3"], ["b2", "c4"]]
    dbX = outsource(X, column_names=["A", "B"], codec=codec6, n_shares=16,
                    seed=8, device=device)
    dbY = outsource(Y, column_names=["B", "C"], codec=codec6, n_shares=16,
                    seed=9, device=device)
    res = QueryClient(dbX, seed=3, device=device).join(dbY, on=("B", "B"))
    print(f"  -> {res.rows}")
    print("\nAll queries executed obliviously on shares; the clouds saw "
          "only uniform field elements.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions on the CPU; "
                         "the default is the GPU (CUDA kernels)")
    main(ap.parse_args().device)
